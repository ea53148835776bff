"""Run a command and stamp each line of its output with the seconds since
the command started, so that a long log shows where its time went: the
gap before a line is the time of the work that printed it. The stamped
lines go to ``--out``; the ``--top`` largest gaps, with the lines that
close them, are printed at the end. The exit code is the command's.

  python3 tools/line_clock.py --out chiprun_out/smoke.log -- \\
      python3 chip_smoke.py

The command's standard error is merged into its output, and a Python
command runs unbuffered (``PYTHONUNBUFFERED=1``), so each line is stamped
when it is printed.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True, help="the stamped log")
    ap.add_argument("--top", type=int, default=30,
                    help="largest gaps to print at the end")
    ap.add_argument("command", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    command = args.command[1:] if args.command[:1] == ["--"] else \
        args.command
    if not command:
        ap.error("no command given")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    t0 = last = time.perf_counter()
    gaps = []
    with open(args.out, "w") as out, subprocess.Popen(
            command, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, errors="replace", env=env) as proc:
        for line in proc.stdout:
            now = time.perf_counter()
            gaps.append((now - last, now - t0, line.rstrip("\n")))
            last = now
            out.write(f"{now - t0:10.3f} {line}")
            out.flush()
    total = time.perf_counter() - t0
    print(f"{' '.join(command)}: exit {proc.returncode} in {total:.1f} s; "
          f"the {args.top} largest gaps (s, at s, the line closing it):")
    for gap, at, line in sorted(gaps, reverse=True)[:args.top]:
        print(f"{gap:9.3f} {at:10.3f} {line[:160]}")
    return proc.returncode


if __name__ == "__main__":
    sys.exit(main())
