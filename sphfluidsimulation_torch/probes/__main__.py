"""``python -m sphfluidsimulation_torch.probes NAME [--device cpu]``: runs
one probe (or ``all``), prints its lines, then one JSON line of its
numbers."""

from __future__ import annotations

import argparse
import json
import sys

from . import NAMES, run
from .common import identity, resolve


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="python -m sphfluidsimulation_torch."
                                "probes", description=__doc__)
    p.add_argument("name", choices=NAMES + ("all",))
    p.add_argument("--device", default="cuda",
                   help="torch device (default: the card; cpu runs the "
                   "plain versions)")
    args = p.parse_args(argv)
    dev = resolve(args.device)
    names = NAMES if args.name == "all" else (args.name,)
    out = {"device": identity(dev), "probes": {}}
    for name in names:
        out["probes"][name] = run(name, dev)
    out["ok"] = all(r["ok"] for r in out["probes"].values())
    print(json.dumps(out, default=str), flush=True)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
