"""Start an N-rank run on one machine (torch.distributed over localhost).

Port of tools/launch_multihost.py. Each child gets the environment that
parallel/distributed.initialize reads: LIFELIKE_COORDINATOR (127.0.0.1 and
a free port), LIFELIKE_NUM_PROCESSES, LIFELIKE_PROCESS_ID, and
LIFELIKE_BACKEND when a backend is asked for (gloo lets several ranks
share one card; NCCL refuses that). With --cpu every child runs with
OMP_NUM_THREADS=1: ranks side by side that each spin a thread per core
slow each other down.

The first child to exit with a non-zero code has its siblings killed
(each child leads a process group of its own, and the whole group is
killed, so nothing it started lives on), so no rank is left waiting in a
collective for a peer that died; a run past --timeout is killed the same
way. The exit code is non-zero if any child failed.

    python -m lifelike_tpu_torch.tools.launch_multihost -n 2 --cpu -- \\
        python -m lifelike_tpu_torch.tools.multihost_worker --device=cpu
    python -m lifelike_tpu_torch.tools.launch_multihost -n 2 --backend=gloo -- \\
        python -m lifelike_tpu_torch.bin.run_learner --task=pmc --num_envs=256
"""
import argparse
import os
import signal
import socket
import subprocess
import sys
import time

KILL_GRACE_S = 5.0


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def rank_env(rank, n, port, backend=None, cpu=False, base=None) -> dict:
    """The environment of rank `rank` of `n`."""
    env = dict(os.environ if base is None else base)
    env.update(LIFELIKE_COORDINATOR=f"127.0.0.1:{port}", LIFELIKE_NUM_PROCESSES=str(n),
               LIFELIKE_PROCESS_ID=str(rank))
    env.pop("LIFELIKE_LOCAL_DEVICES", None)
    if backend:
        env["LIFELIKE_BACKEND"] = backend
    if cpu:
        env["OMP_NUM_THREADS"] = "1"
    return env


def _signal(p, sig):
    try:
        os.killpg(p.pid, sig)
    except ProcessLookupError:  # the group has exited meanwhile
        pass


def _kill(procs):
    """SIGTERM the process group of every running child, SIGKILL after
    KILL_GRACE_S."""
    for p in procs:
        if p.poll() is None:
            _signal(p, signal.SIGTERM)
    deadline = time.monotonic() + KILL_GRACE_S
    for p in procs:
        try:
            p.wait(max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            _signal(p, signal.SIGKILL)
            p.wait()


def launch(cmd, n, backend=None, cpu=False, log_dir=None, timeout=None, env=None, port=0,
           cwd=None) -> list:
    """Run `cmd` as ranks 0..n-1 and wait for them; returns their exit
    codes (a killed child's is negative). log_dir: each rank's stdout and
    stderr go to log_dir/rank{r}.log (else they are inherited). env: the
    base environment (default os.environ)."""
    port = port or free_port()
    procs, files = [], []
    try:
        for r in range(n):
            out = None
            if log_dir:
                os.makedirs(log_dir, exist_ok=True)
                out = open(os.path.join(log_dir, f"rank{r}.log"), "w")
                files.append(out)
            renv = rank_env(r, n, port, backend, cpu, env)
            if out:
                renv["PYTHONUNBUFFERED"] = "1"  # whole lines in the log as they come
            procs.append(subprocess.Popen(
                cmd, env=renv, cwd=cwd, stdout=out,
                stderr=subprocess.STDOUT if out else None, start_new_session=True))
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            rcs = [p.poll() for p in procs]
            if all(rc is not None for rc in rcs):
                return rcs
            if any(rc not in (None, 0) for rc in rcs):
                print(f"launch_multihost: a rank exited with {rcs}; killing the others",
                      file=sys.stderr, flush=True)
                break
            if deadline is not None and time.monotonic() > deadline:
                print(f"launch_multihost: past the {timeout} s limit; killing every rank",
                      file=sys.stderr, flush=True)
                break
            time.sleep(0.05)
        _kill(procs)
        return [p.returncode for p in procs]
    finally:
        _kill(procs)
        for f in files:
            f.close()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("-n", "--num_processes", type=int, default=2)
    ap.add_argument("--backend", default="", help="nccl or gloo (LIFELIKE_BACKEND)")
    ap.add_argument("--cpu", action="store_true", help="CPU ranks: OMP_NUM_THREADS=1 each")
    ap.add_argument("--log_dir", default="", help="rank{r}.log per rank here")
    ap.add_argument("--timeout", type=float, default=0.0, help="kill every rank after s (0: none)")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("cmd", nargs=argparse.REMAINDER, help="-- then the worker command")
    args = ap.parse_args(argv)
    cmd = args.cmd[1:] if args.cmd and args.cmd[0] == "--" else args.cmd
    if not cmd:
        ap.error("worker command required after --")
    rcs = launch(cmd, args.num_processes, backend=args.backend or None, cpu=args.cpu,
                 log_dir=args.log_dir or None, timeout=args.timeout or None, port=args.port)
    if any(rcs):
        print(f"launch_multihost: child exit codes {rcs}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
