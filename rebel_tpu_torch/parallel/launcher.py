"""Local multi-process launcher and ``--mode kill``, the counterpart of
``rebel_tpu/parallel/launcher.py``.

``launch_local`` starts N copies of a command, each with ``--dist
host:port,N,i`` appended, which join one ``torch.distributed`` process
group (:func:`rebel_tpu_torch.parallel.distributed.initialize`).  It
records the exact PIDs and command lines in ``<exp_dir>/jobs.json``, so
that ``kill_experiment`` signals precisely the processes it started, never
by name or pattern, and never a PID that now belongs to another command.
Ranks 1..N-1 write to ``<exp_dir>/log.rank<i>.txt``; rank 0 writes to the
parent's streams.  When one child fails, or the parent is interrupted,
the whole group is stopped.
"""

from __future__ import annotations

import json
import logging
import os
import pathlib
import signal
import socket
import subprocess
import sys
import time

log = logging.getLogger(__name__)

JOBS_FILE = "jobs.json"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_local(child_argv: list[str], num_processes: int,
                 exp_dir: pathlib.Path, coordinator: str | None = None,
                 timeout: float | None = None,
                 env: dict | None = None) -> int:
    """Start ``num_processes`` children of ``child_argv`` (the arguments
    after the interpreter), each with ``--dist host:port,N,i`` appended,
    in the environment ``env`` (default: the parent's), and wait for them.
    Returns the first non-zero exit code of a child (0 when all succeed).
    A group that outlasts ``timeout`` seconds is stopped and
    ``TimeoutError`` raised."""
    exp_dir = pathlib.Path(exp_dir)
    exp_dir.mkdir(parents=True, exist_ok=True)
    coordinator = coordinator or f"127.0.0.1:{_free_port()}"
    deadline = None if timeout is None else time.time() + timeout
    procs: list[subprocess.Popen] = []
    jobs = {"coordinator": coordinator, "procs": []}
    try:
        for i in range(num_processes):
            argv = [sys.executable] + child_argv + [
                "--dist", f"{coordinator},{num_processes},{i}"]
            logf = open(exp_dir / f"log.rank{i}.txt", "ab") if i else None
            try:
                p = subprocess.Popen(argv, stdout=logf, stderr=logf,
                                     env=env, start_new_session=True)
            finally:
                if logf is not None:
                    logf.close()  # the child holds its own descriptor
            procs.append(p)
            jobs["procs"].append({"pid": p.pid, "rank": i, "argv": argv})
        (exp_dir / JOBS_FILE).write_text(json.dumps(jobs, indent=1))
        log.info("launched %d processes (coordinator %s); pids %s",
                 num_processes, coordinator, [p.pid for p in procs])
        rc = 0
        while procs:
            if deadline is not None and time.time() > deadline:
                raise TimeoutError(f"{num_processes} processes outlasted "
                                   f"{timeout} s")
            for p in list(procs):
                ret = p.poll()
                if ret is None:
                    continue
                procs.remove(p)
                if ret != 0:
                    rc = rc or ret
                    log.error("child pid %d exited rc=%d; stopping the "
                              "group", p.pid, ret)
                    _kill_procs([q.pid for q in procs])
            time.sleep(0.2)
        return rc
    except BaseException:
        # An interrupt or a failed spawn must not leave children waiting
        # for peers that will never join (their PIDs reach jobs.json only
        # after the whole spawn loop).
        _kill_procs([p.pid for p in procs])
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        raise
    finally:
        (exp_dir / JOBS_FILE).unlink(missing_ok=True)


def _pid_matches(pid: int, argv: list[str]) -> bool:
    """Whether ``pid``'s ``/proc`` command line still is ``argv``: a
    recycled PID is never signalled, and nor is anything when no command
    line was recorded."""
    if not argv:
        return False
    try:
        cmd = pathlib.Path(f"/proc/{pid}/cmdline").read_bytes()
    except OSError:
        return False
    parts = [c for c in cmd.decode(errors="replace").split("\0") if c]
    return parts[:len(argv)] == argv or parts == argv


def _kill_procs(pids: list[int], sig=signal.SIGTERM) -> None:
    for pid in pids:
        try:
            os.kill(pid, sig)
        except OSError:
            pass


def kill_experiment(exp_dir: pathlib.Path) -> int:
    """``--mode kill``: SIGTERM the PIDs of ``jobs.json`` whose command
    lines still match, SIGKILL what is left after 10 s, remove
    ``jobs.json``.  Returns the number of processes signalled."""
    exp_dir = pathlib.Path(exp_dir)
    jobs_path = exp_dir / JOBS_FILE
    if not jobs_path.exists():
        log.info("no %s in %s; nothing to kill", JOBS_FILE, exp_dir)
        return 0
    jobs = json.loads(jobs_path.read_text())
    live = lambda js: [j for j in js
                       if _pid_matches(j["pid"], j.get("argv", []))]
    victims = live(jobs.get("procs", []))
    _kill_procs([j["pid"] for j in victims], signal.SIGTERM)
    deadline = time.time() + 10
    while time.time() < deadline and live(victims):
        time.sleep(0.2)
    _kill_procs([j["pid"] for j in live(victims)], signal.SIGKILL)
    jobs_path.unlink(missing_ok=True)
    log.info("killed %d processes", len(victims))
    return len(victims)
