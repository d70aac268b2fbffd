"""Repeat chip_smoke.py's fp32_xlsr2b phase with its learning steps on the kernel and the plain path.

    python3 probe_xl_learning.py [--lr LR [LR ...]]

Run from the repository root, beside ``chip_smoke.py``, whose phase it
repeats; needs one CUDA device. For each rate (by default 5e-5, the rate
of xlarge and fp32_xlarge, and 3.33e-5, fp32_xlsr2b's) it runs the phase
(fp32 CTC fine-tuning at XLS-R 2B's width, 12 layers, seed 0, every check
and gate as chip_smoke.py runs them) with its learning steps at that rate:
XL_LEARN_STEPS unfrozen steps on one batch from a fresh head, first
through the plain versions (``chip_smoke.plain_ops``), then from the same
weights and the same dropout seeds through the kernels, which the phase's
gate reads. It prints both paths' losses per rate and whether each fell
(the gate: the last loss under the first), so a loss that rises on both
paths shows the rate at fault and not the kernels.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import sys

import torch

import chip_smoke as cs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lr", type=float, nargs="+", default=[5e-5, 3.33e-5])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_xl_learning: needs a CUDA device", file=sys.stderr)
        return 1
    dev, smi = cs.card_setup()
    wav, lengths = cs.smoke_batch(dev)
    learning = cs.xlarge_learning

    def both_paths(model, step, batch, gen, dev_, lr):
        weights = {k: v.detach().clone() for k, v in model.state_dict().items()}
        draws = gen.get_state()
        got = {}
        for path in ("plain", "kernel"):
            model.load_state_dict(weights)
            gen.set_state(draws)
            with cs.plain_ops() if path == "plain" else contextlib.nullcontext():
                got[path] = learning(model, step, batch, gen, dev_, lr)
            print(f"[probe] lr={lr:.3g} path={path} falls={got[path][-1] < got[path][0]} "
                  f"losses={','.join(f'{x:.3f}' for x in got[path])}", flush=True)
        del weights
        return got["kernel"]

    cs.xlarge_learning = both_paths
    for lr in args.lr:
        try:
            cs.xlarge_train_phase(dev, cs.kernel_counters(), wav, lengths, smi,
                                  dtype=torch.float32, make_config=cs.xlsr2b_config,
                                  tag="fp32_xlsr2b", head_dim=120, lr=lr)
            print(f"[probe] lr={lr:.3g} phase=passed", flush=True)
        except RuntimeError as e:
            print(f"[probe] lr={lr:.3g} phase=failed: {e}", flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
