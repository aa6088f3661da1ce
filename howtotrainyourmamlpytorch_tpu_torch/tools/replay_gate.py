"""Run ``chip_smoke.py``'s replayed meta-gradient gate
(``check_grads_replayed``) for the strided Omniglot model (20-way 1-shot
with ``max_pooling=False``) or the norm-first mini-ImageNet model (5-way
5-shot with ``block_order='norm_conv_relu'``), second order, batch 2, in
f32 or bf16 on the chosen data seeds, and print what that gate prints: per
seed the decisions unlike f64, and over the seeds the quantiles (median,
p90, max) of the kernels' error over the larger plain run's, leaf by leaf,
and of the null ratios. The check that one build's kernels sit no farther
from f64 than another's at the gate's tail, compared in one call on one
card.

    PYTHONPATH=<checkout> python3 <this file> [--dtype bfloat16]
                                              [--model strided]
                                              [--seeds 0,1,...,9]

``chip_smoke`` is imported from the checkout that ``PYTHONPATH`` names, so
each build is held by its own gate code and its own kernels (each checkout
builds them into its own ``_build/``). Prints the card's ``nvidia-smi``
line first. Exits 1 where a ratio passes the gate's factor. Needs one
card.
"""

from __future__ import annotations

import argparse
import sys


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--model", default="strided",
                    choices=("strided", "norm-first"))
    ap.add_argument("--seeds", default=",".join(map(str, range(10))))
    args = ap.parse_args(argv)

    import chip_smoke as cs
    from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
    from howtotrainyourmamlpytorch_tpu_torch.device import resolve_device
    from howtotrainyourmamlpytorch_tpu_torch.kernels import conv_block as cb
    from howtotrainyourmamlpytorch_tpu_torch.ops import functional as F

    print(cs.card_line(), flush=True)
    resolve_device("cuda:0")
    if args.model == "strided":
        cfg = MAMLConfig.from_json_file(cs.OMNIGLOT).replace(
            max_pooling=False, compute_dtype=args.dtype)
        what = "strided Omniglot"
    else:
        cfg = MAMLConfig.from_json_file(cs.FLAGSHIP).replace(
            block_order="norm_conv_relu", compute_dtype=args.dtype)
        what = "norm-first mini-ImageNet"
    seeds = tuple(int(v) for v in args.seeds.split(","))
    print(f"[replay gate] {what} {args.dtype}, seeds {seeds}", flush=True)
    try:
        cs.check_grads_replayed(cfg, cb, F, seeds)
    except AssertionError as err:
        print(f"[replay gate] FAILED: {err}", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
