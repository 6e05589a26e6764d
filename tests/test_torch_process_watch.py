"""``tools/process_watch.py``: a command's exit code, the time from its last
line to its exit, and the processes it leaves running.  ``chip_smoke.py``
must leave none, also where it refuses to run (no card here)."""
import json
import os
import signal
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(ROOT, "tools", "process_watch.py")


def watch(tmp_path, *cmd):
    proc = subprocess.run([sys.executable, TOOL, "--out", str(tmp_path),
                           "--interval", "0.1", "--", *cmd], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary["rc"] == proc.returncode
    return summary


def test_a_clean_command_leaves_nothing(tmp_path):
    summary = watch(tmp_path, sys.executable, "-c",
                    "print('one'); print('two'); raise SystemExit(3)")
    assert summary["rc"] == 3
    assert (tmp_path / "stdout.txt").read_text() == "one\ntwo\n"
    assert 0 <= summary["last_line_to_exit_s"] < 5
    assert summary["left"] == {"+0 s": [], "+1 s": [], "+3 s": []}


def test_a_process_left_running_is_reported(tmp_path):
    summary = watch(tmp_path, "sh", "-c",
                    "sleep 30 >/dev/null 2>&1 & echo started")
    left = summary["left"]
    try:
        assert summary["rc"] == 0
        for reading in ("+0 s", "+1 s", "+3 s"):
            assert [p.split(" ", 2)[2] for p in left[reading]] == [
                "sleep 30"], left
    finally:
        for entry in {p for r in left.values() for p in r}:
            os.kill(int(entry.split(" ", 1)[0]), signal.SIGKILL)


def test_chip_smoke_without_a_card_fails_and_leaves_nothing(tmp_path):
    summary = watch(tmp_path, sys.executable, "chip_smoke.py")
    assert summary["rc"] != 0
    assert (tmp_path / "stdout.txt").read_text() == ""
    assert summary["left"] == {"+0 s": [], "+1 s": [], "+3 s": []}
