"""Compare ptxas's report for every kernel of two checkouts, on a machine
with nvcc.

    python3 paddle_tpu_torch/tools/ptxas_compare.py OLD_ROOT NEW_ROOT

Builds each checkout's libraries with that checkout's own
``_build.build()`` (each in a process of its own, both at once; a
library already built in a checkout is kept), reads the ptxas report
kept beside each library, and prints one line per kernel of OLD_ROOT:
its registers, stack bytes, spill-store and spill-load bytes in both
trees. A kernel that NEW_ROOT templates on its operand type is matched
by its bf16 instance (``k<64, bf16>`` for OLD_ROOT's ``k<64>``, ``k<bf16>``
for OLD_ROOT's ``k``); kernels only NEW_ROOT has are listed after. The names and reports are read as
``chip_smoke.py`` phase 2 reads them (NEW_ROOT's ``ptxas_report``). Exits
1 if a kernel of OLD_ROOT is missing from NEW_ROOT or reads otherwise
there.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

KEYS = ("registers", "stack", "spill_stores", "spill_loads")
BUILD = ("import json, sys; sys.path.insert(0, sys.argv[1]); "
         "from paddle_tpu_torch import _build; "
         "print(json.dumps({k: str(v) for k, v in _build.build().items()}))")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        raise SystemExit(__doc__)
    roots = [str(Path(r).resolve()) for r in argv]
    procs = [subprocess.Popen([sys.executable, "-c", BUILD, root],
                              stdout=subprocess.PIPE, text=True)
             for root in roots]
    paths = []
    for root, proc in zip(roots, procs):
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit("ptxas_compare: the build of %s failed" % root)
        paths.append(json.loads(out.strip().splitlines()[-1]))
    sys.path.insert(0, roots[1])
    from chip_smoke import ptxas_report

    def report(path):
        return ptxas_report(Path(path + ".log").read_text())

    differ = 0
    for name, old_path in paths[0].items():
        new = {r["kernel"]: r for r in report(paths[1][name])}
        seen = set()
        for r in report(old_path):
            kernel = r["kernel"]
            twin = (kernel[:-1] + ", bf16>" if kernel.endswith(">")
                    else kernel + "<bf16>")
            key = kernel if kernel in new else twin
            n = new.get(key)
            seen.add(key)
            same = n is not None and all(n.get(k) == r.get(k) for k in KEYS)
            differ += not same
            print("%s %s: %s -> %s%s %s" % (
                name, kernel, [r.get(k) for k in KEYS],
                None if n is None else [n.get(k) for k in KEYS],
                "" if key == kernel else " (as %s)" % key,
                "same" if same else "DIFFERENT"), flush=True)
        for kernel in sorted(set(new) - seen):
            print("%s %s: only in the new tree: %s" % (
                name, kernel, [new[kernel].get(k) for k in KEYS]))
    print("ptxas_compare: %s" % ("every kernel of the old tree reads the "
                                 "same" if not differ else
                                 "%d kernels differ" % differ), flush=True)
    sys.exit(1 if differ else 0)


if __name__ == "__main__":
    main()
