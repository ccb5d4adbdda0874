"""Run ``chip_smoke.py`` phase 16d (the small model's training recipe, its
unseeded augmenter included) several times in one process and report, for
each run, whether its gate held and every conv weight's largest |gradient|
a step for the weights that did not move and the four with the smallest
gradients.

    python3 tools/torch_c8_probe.py [--runs 10]

Needs a CUDA card; builds the kernels first, as ``chip_smoke.py`` does.
"""

import argparse
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--runs", type=int, default=10)
    args = parser.parse_args()
    import torch

    import chip_smoke as cs
    from mft_tpu_torch import ops
    from mft_tpu_torch.ops import _build
    if not torch.cuda.is_available():
        print("torch_c8_probe: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = cs.card_line()
    cs.log(card)
    _build.library()
    failed = 0
    for run in range(args.runs):
        t0 = time.perf_counter()
        try:
            cs.run_small_training(torch, ops, dev, card)
            verdict = "held"
        except cs.CheckFailed as e:
            failed += 1
            verdict = f"FAILED: {e}"
        cs.log(f"probe run {run + 1}/{args.runs}: phase 16d {verdict} "
               f"({time.perf_counter() - t0:.1f} s)")
    cs.log(f"probe: {args.runs - failed} of {args.runs} runs held [{card}]")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
