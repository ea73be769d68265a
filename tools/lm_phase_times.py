"""Time the LM phases of a checkout's ``chip_smoke.py`` on one card.

    python3 tools/lm_phase_times.py [CHECKOUT]

Loads ``chip_smoke.py`` from CHECKOUT (default: this repository's root),
which puts that checkout's ``src`` first on the path, and runs its kernel
build, the flash kernel's checks, the LM serving path and the small LM
references as its ``main`` runs them, printing each one's seconds and,
last, one JSON object of them. Run it once per checkout, each in its own
process, in one call on one card: the difference is what a change to
those phases costs on that host.
"""
from __future__ import annotations

import importlib.util
import json
import pathlib
import sys
import time


def main() -> None:
    root = pathlib.Path(sys.argv[1] if len(sys.argv) > 1 else
                        pathlib.Path(__file__).resolve().parents[1])
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", root.resolve() / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    card = cs.nvidia_smi()
    print(card)
    cs.torch.backends.cuda.matmul.allow_tf32 = False
    cs.torch.backends.cudnn.allow_tf32 = False
    seconds = {}

    def timed(name, run):
        t = time.perf_counter()
        out = run()
        seconds[name] = time.perf_counter() - t
        print(f"lm_phase_times: {name} {seconds[name]!r} s", flush=True)
        return out

    timed("build_phase", cs.build_phase)
    flash = timed("flash_phase", lambda: cs.flash_phase(card))
    entries = [flash, {"name": "wkv"}, {"name": "ssd"}]
    timed("serve_path", lambda: cs.serve_path(card, entries))
    timed("small_lm_reference", cs.small_lm_reference)
    print(f"[{card}] {root}: " + json.dumps(seconds))


if __name__ == "__main__":
    main()
