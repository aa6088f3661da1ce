"""Save, or compare bit for bit, the conv kernels' and the batch-norm
kernels' outputs on fixed inputs: the check that a change to some kernels
left the others what they were.

    PYTHONPATH=<parent checkout> python3 <this file> save bits.pt
    PYTHONPATH=<this checkout> python3 <this file> compare bits.pt
    PYTHONPATH=<this checkout> python3 <this file> twin

Run by path, so that ``PYTHONPATH`` picks the package whose kernels are
built and launched; each tree builds its own kernels into its own
``_build/``. The inputs come from numpy seeds; each kernel runs in f32 and
in bf16 on the card: the convs at stride 1 and 2 and at pad 1 and 0 (K1
with statistics and stats-free, with and without bias; K4 dgrad and
wgrad), and on each stride-1 conv output K2 (``bn_act_pool_fwd``), K3 and
K5 pooled (``bn_act_pool_bwd``, ``bn_act_pool_bwd_bwd``) and pool-free
(``bn_act_*``, and at slope 1 ``batch_norm_*``).

``compare`` prints one line per output and exits 1 unless every output is
``torch.equal`` to the saved one: every conv output, K2 pooled and
pool-free in both dtypes (``csrc/bn_act_fwd.cu`` rounds as the Triton
kernels before it did), and K3 and K5 pooled and pool-free in both
dtypes. An output that differs is a fault to explain, not an exception
to allow; each bf16 output that differs also prints its largest distance
from the saved one in bf16 ulps (of the larger magnitude) and whether it
lies within one ulp of the saved value or 1e-4 of its largest magnitude,
elementwise (``chip_smoke.within_ulp``'s gate). ``twin`` computes the same
outputs with the plain twins (the wrappers' CPU route, on the same
inputs) and prints each bf16 output's largest distance from this build's
in bf16 ulps, and whether it lies within that gate of the twin's (the
card's gate for a kernel that rounds f32 sums once; K2, K3 and K5 here
take this build's conv outputs, the twins the twin's, and a y with a bias
rounds twice). Needs one card.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

# T, N, H, W, cin, cout: mini-ImageNet stage 0 (cin 3) and a 48-channel
# map, an odd map at stride 2 (7 -> 4), Omniglot's image layer (cin 1)
SHAPES = ((2, 5, 84, 84, 3, 48), (2, 5, 21, 21, 48, 48),
          (2, 4, 7, 8, 3, 20), (2, 4, 14, 14, 1, 64))
DTYPES = (torch.float32, torch.bfloat16)


def _inputs(i, shape, device):
    T, N, H, W, cin, cout = shape
    rng = np.random.RandomState(i)

    def r(*dims, scale=1.0):
        return torch.from_numpy(
            (rng.randn(*dims) * scale).astype(np.float32)).to(device)

    return (r(T, N, H, W, cin),
            r(T, 3, 3, cin, cout, scale=(2.0 / (9 * cin)) ** 0.5),
            r(T, cout, scale=0.1), rng)


def bn_outputs(key, y, mean, rstd, rng):
    """{key: output} of K2, K3 and K5 on the conv output ``y`` with its
    statistics: pooled, and pool-free at the leaky slope and at slope 1."""
    from howtotrainyourmamlpytorch_tpu_torch.kernels import conv_block as cb
    from howtotrainyourmamlpytorch_tpu_torch.ops import functional as F

    T, N, H, W, C = y.shape

    def r(*dims):
        return torch.from_numpy(
            rng.randn(*dims).astype(np.float32)).to(y.device).to(y.dtype)

    gamma, beta = 1.0 + 0.1 * r(T, C), 0.1 * r(T, C)
    pooled, arg = cb.bn_act_pool_fwd(y, mean, rstd, gamma, beta)
    dp, a, da = r(*pooled.shape), r(*y.shape), r(*y.shape)
    k3 = (dp, arg, y, mean, rstd, gamma, beta)
    k5 = (a, r(T, C), r(T, C)) + k3
    got = (cb.bn_act_pool_bwd(*k3) + cb.bn_act_pool_bwd_bwd(*k5)
           + (pooled, arg))
    free = (da, y, mean, rstd, gamma, beta)
    for slope in (F.LEAKY_SLOPE, 1.0):
        got += (cb.bn_act_fwd(*free[1:], slope),) + cb.bn_act_bwd(
            *free, slope) + cb.bn_act_bwd_bwd(a, k5[1], k5[2], *free,
                                              slope)
    names = [f"bn_act_pool_bwd {n}" for n in ("dy", "dgamma", "dbeta")]
    names += [f"bn_act_pool_bwd_bwd {n}"
              for n in ("g_dpooled", "g_y", "g_gamma")]
    names += ["bn_act_pool_fwd pooled", "bn_act_pool_fwd argmax"]
    for slope in ("leaky", "1"):
        names += [f"pool-free K2 (slope {slope}) activation"]
        names += [f"pool-free K3 (slope {slope}) {n}"
                  for n in ("dy", "dgamma", "dbeta")]
        names += [f"pool-free K5 (slope {slope}) {n}"
                  for n in ("g_da", "g_y", "g_gamma")]
    return {f"{key} {n}": v for n, v in zip(names, got)}


def outputs(device="cuda"):
    """{key: output} of every kernel call: the kernels' on the card, the
    plain twins' on the CPU."""
    from howtotrainyourmamlpytorch_tpu_torch.kernels import conv_block as cb

    out = {}
    for i, shape in enumerate(SHAPES):
        x32, w32, b32, rng = _inputs(i, shape, device)
        H, W = shape[2:4]
        for dtype in DTYPES:
            x, w, b = (t.to(dtype) for t in (x32, w32, b32))
            for s in (1, 2):
                for p in (1, 0):
                    key = (f"{str(dtype)[6:]} {shape} stride {s} pad {p}")
                    y = cb.conv3x3_fwd(x, w, b, s, p)
                    dy = torch.from_numpy(
                        rng.randn(*y.shape).astype(np.float32)).to(device)
                    dy = dy.to(dtype)
                    stats = cb.conv3x3_fwd_stats(x, w, b, stride=s,
                                                 padding=p)
                    if s == 1:
                        out.update(bn_outputs(key, stats[0], stats[1],
                                              stats[3], rng))
                    out.update({f"{key} fwd_stats {n}": v for n, v in zip(
                        ("y", "mean", "var", "rstd"), stats)})
                    out[f"{key} fwd"] = y
                    out[f"{key} fwd (no bias)"] = cb.conv3x3_fwd(x, w, None,
                                                                 s, p)
                    out[f"{key} dgrad"] = cb.conv3x3_dgrad(dy, w, s, (H, W),
                                                           p)
                    dw, db = cb.conv3x3_wgrad(x, dy, s, p)
                    out[f"{key} wgrad dw"], out[f"{key} wgrad db"] = dw, db
    if device != "cpu":
        torch.cuda.synchronize()
    return {k: v.cpu() for k, v in out.items()}


def bf16_ulps(got, want):
    """The largest |got - want| of two bf16 tensors in bf16 ulps of the
    larger magnitude at each element."""
    a, b = got.double(), want.double()
    big = torch.maximum(a.abs(), b.abs()).clamp_min(2.0 ** -126)
    _, e = torch.frexp(big)
    return ((a - b).abs() / torch.ldexp(torch.ones_like(big), e - 8)
            ).max().item()


def within_gate(got, want):
    """|got - want| <= max(one bf16 ulp of want, 1e-4 max |want|)
    elementwise (``chip_smoke.within_ulp``'s default gate)."""
    a, b = got.double(), want.double()
    _, e = torch.frexp(b.abs().clamp_min(2.0 ** -126))
    tol = torch.clamp_min(torch.ldexp(torch.ones_like(b), e - 8),
                          1e-4 * b.abs().max().item())
    return bool(((a - b).abs() <= tol).all())


def main(argv) -> int:
    if argv == ["twin"]:
        if not torch.cuda.is_available():
            raise SystemExit("conv_pad1_bits: needs a CUDA card")
        from howtotrainyourmamlpytorch_tpu_torch.device import resolve_device

        resolve_device("cuda:0")
        got, twin = outputs(), outputs("cpu")
        for k, v in got.items():
            if v.dtype == torch.bfloat16:
                gate = "within" if within_gate(v, twin[k]) else "OUTSIDE"
                print(f"{bf16_ulps(v, twin[k]):6.2f} ulps from the twin, "
                      f"{gate} the gate  {k}", flush=True)
        return 0
    if len(argv) != 2 or argv[0] not in ("save", "compare"):
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("conv_pad1_bits: needs a CUDA card")
    from howtotrainyourmamlpytorch_tpu_torch.device import resolve_device

    resolve_device("cuda:0")
    got = outputs()
    if argv[0] == "save":
        torch.save(got, argv[1])
        print(f"saved {len(got)} outputs to {argv[1]}")
        return 0
    want = torch.load(argv[1])
    same = 0
    for k, v in want.items():
        equal = k in got and torch.equal(got[k], v)
        same += equal
        line = f"{'equal' if equal else 'DIFFERS'}  {k}"
        if k in got and not equal:
            diff = (got[k].float() - v.float()).abs().max().item()
            line += f"  max |diff| {diff:.3e}"
            if v.dtype == torch.bfloat16:
                gate = "within" if within_gate(got[k], v) else "OUTSIDE"
                line += (f" ({bf16_ulps(got[k], v):.2f} bf16 ulps, {gate} "
                         "the gate)")
        print(line, flush=True)
    new = sorted(set(got) - set(want))
    for k in new:
        print(f"not saved  {k}", flush=True)
    print(f"{same} of {len(want)} saved outputs bit-identical to this "
          f"build's; {len(new)} outputs this build computes that the saved "
          f"build did not: every output equal: "
          f"{same == len(want) and not new}", flush=True)
    return 0 if same == len(want) and not new else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
