"""Package CLI: ``python -m pysvihmm_tpu_torch <command> [args]``.

Commands:
  experiment  config-driven engine runs (pysvihmm_tpu_torch/scripts/run_experiment.py)
  baseline    the BASELINE evaluation configs 1-3
              (pysvihmm_tpu_torch/scripts/run_baseline_configs.py)
  bench       not ported yet (ROADMAP Queue 1 item 1, the port's benchmark)

Every command runs on the card unless given ``--device cpu``.
"""

from __future__ import annotations

import sys


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd == "experiment":
        from .scripts import run_experiment

        return run_experiment.main(rest)
    if cmd == "baseline":
        from .scripts import run_baseline_configs

        return run_baseline_configs.main(rest)
    if cmd == "bench":
        print("bench: the port's benchmark is not written yet (ROADMAP Queue 1 item 1)",
              file=sys.stderr)
        return 2
    print(f"unknown command {cmd!r}; one of: experiment, baseline, bench", file=sys.stderr)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
