#!/usr/bin/env python3
"""Run some of ``chip_smoke.py``'s phases alone, in one process on the card.

    python3 tools/chip_phases.py card flash-sweep timing-flash multimodal

``card`` builds the kernels (and checks the registers) and is run first
whether named or not; the others run in the order given, with the
script's settings (deterministic algorithms, no TF32). ``timing-flash``
prints the kernels line's flash row. Each phase prints its lines and its
``wall_s`` as in the whole script; the first failure ends the run with
its message. For the whole script's contract run ``python3 chip_smoke.py``.
"""
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402  (puts the checkout's src/ first)
import torch  # noqa: E402

PHASES = {
    "flash-sweep": lambda card: cs.phase_flash_sweep(),
    "flash-bwd-sweep": lambda card: cs.phase_flash_bwd_sweep(),
    "timing-flash": lambda card: print(json.dumps(cs.phase_flash_timing(0), default=str)),
    "hybrid": cs.phase_hybrid,
    "moe": cs.phase_moe,
    "multimodal": cs.phase_multimodal,
}


def main(names: list[str]) -> int:
    unknown = [n for n in names if n != "card" and n not in PHASES]
    if unknown or not torch.cuda.is_available():
        print(f"chip_phases: unknown phases {unknown} (have card, {', '.join(PHASES)}), "
              f"or no CUDA device", file=sys.stderr)
        return 1
    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with cs._clock("card"):
        card = cs.phase_card()
    for name in names:
        if name != "card":
            with cs._clock(name):
                PHASES[name](card)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
