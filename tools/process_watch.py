"""Run a command and report the processes it starts and leaves behind.

Usage::

    python3 tools/process_watch.py [--out DIR] [--interval S] -- CMD [ARG...]

The command's standard output goes to ``DIR/stdout.txt`` and its errors to
``DIR/stderr.txt``.  The machine's processes are read from ``/proc``
every ``S`` seconds while the command runs (its descendants are
recorded) and 0, 1 and 3 seconds after it exits.  The command starts a
session of its own, so whatever it starts stays in that session (unless
it leaves the session itself) after its parent has ended.  The last
line printed is one JSON object: the exit code, the run's seconds, the
seconds from the command's last line of output to the end of its output
and to its exit, the programs seen among its descendants, and every
process of its session still running after it (``left``, one list per
reading).  It exits with the command's code.  Linux only; it reads
``/proc`` and changes nothing.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time


def processes() -> dict[int, tuple[int, int, str, str]]:
    """Every process: pid -> (parent pid, session, state, command line)."""
    out = {}
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                state, ppid, _, sid = f.read().rsplit(")", 1)[1].split()[:4]
            with open(f"/proc/{name}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
        except OSError:
            continue
        out[int(name)] = (int(ppid), int(sid), state, cmd.strip())
    return out


def descendants(procs, root: int) -> list[int]:
    """The pids under ``root`` in a snapshot (``root`` not included)."""
    kids: dict[int, list[int]] = {}
    for pid, (ppid, *_) in procs.items():
        kids.setdefault(ppid, []).append(pid)
    found, todo = [], list(kids.get(root, ()))
    while todo:
        pid = todo.pop()
        found.append(pid)
        todo.extend(kids.get(pid, ()))
    return found


def left_over(procs, session: int) -> list[str]:
    """The live processes of ``session`` (zombies have ended), as
    ``"pid state command"``."""
    return [f"{pid} {state} {cmd}"
            for pid, (_, sid, state, cmd) in sorted(procs.items())
            if sid == session and state != "Z"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="process_watch")
    ap.add_argument("--interval", type=float, default=2.0)
    ap.add_argument("cmd", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    cmd = args.cmd[1:] if args.cmd[:1] == ["--"] else args.cmd
    if not cmd:
        ap.error("no command given")
    os.makedirs(args.out, exist_ok=True)
    last_line = [None]
    times: dict[str, float] = {}
    seen: set[str] = set()
    with open(os.path.join(args.out, "stdout.txt"), "w") as out, \
            open(os.path.join(args.out, "stderr.txt"), "w") as err:
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=err,
                                text=True, start_new_session=True)

        def copy():
            for line in proc.stdout:
                last_line[0] = time.perf_counter()
                out.write(line)
                out.flush()
            times["eof"] = time.perf_counter()

        ended = threading.Event()

        def wait():
            proc.wait()
            times["exit"] = time.perf_counter()
            ended.set()

        reader = threading.Thread(target=copy)
        waiter = threading.Thread(target=wait)
        reader.start()
        waiter.start()
        while not ended.is_set():
            snap = processes()
            seen.update(snap[pid][3].split(" ", 1)[0].rsplit("/", 1)[-1]
                        for pid in descendants(snap, proc.pid))
            ended.wait(args.interval)
        t_exit = times["exit"]
        left = {}
        for after in (0, 1, 3):
            time.sleep(max(0.0, t_exit + after - time.perf_counter()))
            left[f"+{after} s"] = left_over(processes(), proc.pid)
        # A process left behind may hold the output open: wait a while.
        reader.join(timeout=10.0)
    gap = {}
    if last_line[0] is not None:
        eof = times.get("eof")
        gap = {"last_line_to_eof_s": (None if eof is None
                                      else round(eof - last_line[0], 3)),
               "last_line_to_exit_s": round(t_exit - last_line[0], 3)}
    print(json.dumps({"rc": proc.returncode,
                      "run_s": round(t_exit - t0, 3), **gap,
                      "seen": sorted(seen - {""}), "left": left}),
          flush=True)
    return proc.returncode


if __name__ == "__main__":
    sys.exit(main())
