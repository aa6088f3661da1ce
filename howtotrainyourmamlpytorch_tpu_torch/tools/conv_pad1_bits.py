"""Save, or compare bit for bit, the pad-1 conv kernels' outputs on fixed
inputs: the check that giving the CUDA conv kernels a pad argument left
pad 1 what it was.

    PYTHONPATH=<parent checkout> python3 <this file> save bits.pt
    PYTHONPATH=<this checkout> python3 <this file> compare bits.pt

Run by path, so that ``PYTHONPATH`` picks the package whose kernels are
built and launched; each tree builds its own kernels into its own
``_build/``. The inputs come from numpy seeds; each kernel runs at stride
1 and 2 on the card (K1 with statistics and stats-free, with and without
bias; K4 dgrad and wgrad), called as both trees' wrappers take it (no pad
argument: pad 1). ``compare`` prints one line per output and exits 1 if
any differs (``torch.equal``). Needs one card.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

# T, N, H, W, cin, cout: mini-ImageNet stage 0 (cin 3) and a 48-channel
# map, an odd map at stride 2 (7 -> 4), Omniglot's image layer (cin 1)
SHAPES = ((2, 5, 84, 84, 3, 48), (2, 5, 21, 21, 48, 48),
          (2, 4, 7, 8, 3, 20), (2, 4, 14, 14, 1, 64))


def outputs():
    from howtotrainyourmamlpytorch_tpu_torch.kernels import conv_block as cb

    out = {}
    for i, (T, N, H, W, cin, cout) in enumerate(SHAPES):
        rng = np.random.RandomState(i)

        def r(*shape, scale=1.0):
            return torch.from_numpy(
                (rng.randn(*shape) * scale).astype(np.float32)).cuda()

        x = r(T, N, H, W, cin)
        w = r(T, 3, 3, cin, cout, scale=(2.0 / (9 * cin)) ** 0.5)
        b = r(T, cout, scale=0.1)
        for s in (1, 2):
            key = f"{(T, N, H, W, cin, cout)} stride {s}"
            y, mean, var, rstd = cb.conv3x3_fwd_stats(x, w, b, stride=s)
            out.update({f"{key} fwd_stats {n}": v for n, v in (
                ("y", y), ("mean", mean), ("var", var), ("rstd", rstd))})
            out[f"{key} fwd"] = cb.conv3x3_fwd(x, w, b, s)
            out[f"{key} fwd (no bias)"] = cb.conv3x3_fwd(x, w, None, s)
            dy = r(*y.shape)
            out[f"{key} dgrad"] = cb.conv3x3_dgrad(dy, w, s, (H, W))
            dw, db = cb.conv3x3_wgrad(x, dy, s)
            out[f"{key} wgrad dw"], out[f"{key} wgrad db"] = dw, db
    torch.cuda.synchronize()
    return {k: v.cpu() for k, v in out.items()}


def main(argv) -> int:
    if len(argv) != 2 or argv[0] not in ("save", "compare"):
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("conv_pad1_bits: needs a CUDA card")
    got = outputs()
    if argv[0] == "save":
        torch.save(got, argv[1])
        print(f"saved {len(got)} outputs to {argv[1]}")
        return 0
    want = torch.load(argv[1])
    same = 0
    for k, v in want.items():
        equal = torch.equal(got[k], v)
        same += equal
        print(f"{'equal' if equal else 'DIFFERS'}  {k}"
              + ("" if equal else
                 f"  max |diff| {(got[k] - v).abs().max().item():.3e}"))
    print(f"{same} of {len(want)} pad-1 outputs bit-identical to the saved "
          "build's", flush=True)
    return 0 if same == len(want) and len(got) == len(want) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
