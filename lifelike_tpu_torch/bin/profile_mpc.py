"""Where the time of an MPC solve goes: torch.profiler over closed-loop
solves of bin/run_mpc's controller (--task=pmc, epmc or sepmc).

  python -m lifelike_tpu_torch.bin.profile_mpc --population=4096 --horizon=50 --steps=5
  python -m lifelike_tpu_torch.bin.profile_mpc --task=epmc --population=4096 --horizon=50
  python -m lifelike_tpu_torch.bin.profile_mpc --task=sepmc --population=2048 --horizon=50
  python -m lifelike_tpu_torch.bin.profile_mpc --hybrid --population=1024 --horizon=50 --steps=1
  python -m lifelike_tpu_torch.bin.profile_mpc --device=cpu --population=128 --horizon=3

Takes run_mpc's flags (--hybrid profiles the MPPI->iLQR hybrid solve). After WARMUP closed-loop control steps (solve and
plant step, as in run_mpc), `--steps` solves from the state reached are
timed, then `--steps` more run under the profiler; each starts from the
warm start the one before returned, and the plant is not stepped in
between. Prints the mean solve wall time without and with the profiler
(host clock, the card synchronized after each solve), the device time per
solve summed over the profiler's device events, the device's idle share of
the unprofiled solve (the profiler slows the host, not the kernels), the
kernel launches and memory copies the host issues per solve, and the
operators with the most host and device time; the full tables go to --out
when it is given.
"""
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from lifelike_tpu_torch.bin import run_mpc
from lifelike_tpu_torch.envs import chase_tag, playground, primitive

WARMUP = 2  # control steps before profiling; the first solve builds the kernel


def parse_args(argv=None):
    p = run_mpc.arg_parser(__doc__.split("\n")[0])
    p.add_argument("--out", default=None, help="file for the full operator tables")
    return p.parse_args(argv)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class _Loop:
    """The closed loop of run_mpc's --task: `solve(u)` -> (action, u') from
    the current env state; `advance(action)` steps the plant."""

    def __init__(self, args):
        if args.task == "epmc":
            self.dev, self.model, self.cfg, self.ctrl, self.gen, self.env, self.u = \
                run_mpc.setup_epmc(args)
        elif args.task == "sepmc":
            self.dev, self.model, self.cfg, self.ctrl, self.gen, self.env, self.u = \
                run_mpc.setup_sepmc(args)
        else:
            (self.dev, self.model, self.clips, self.cfg, self.ctrl, self.gen, self.env,
             self.u) = run_mpc.setup_pmc(args)
        self.task = args.task

    def solve(self, u):
        e = self.env
        if self.task == "sepmc":
            tgt, u, _ = self.ctrl(self.gen, e.robots, e.scene, e.flag_pos, e.with_flag, u)
            return tgt - e.robots.joint_pos, u
        if self.task == "epmc":
            tgt, u, _ = self.ctrl(self.gen, e.robot, e.scene, e.target_pos, e.target_spd, u)
        else:
            tgt, u, _ = self.ctrl(self.gen, e.robot, e.clip_idx, e.t, u)
        return tgt - e.robot.joint_pos, u

    def advance(self, action):
        if self.task == "sepmc":
            self.env = chase_tag.step(self.model, self.cfg, self.env, action, self.gen)[0]
        elif self.task == "epmc":
            self.env = playground.step(self.model, self.cfg, self.env, action, self.gen)[0]
        else:
            self.env = primitive.step(self.model, self.clips, self.cfg, self.env, action)[0]


def profile_solve(args, log=print):
    """Returns {"solve_ms", "profiled_solve_ms", "device_ms", "idle_share",
    "launches_per_solve", "memcpys_per_solve", "host_top", "device_top"};
    device figures are None on the CPU."""
    loop = _Loop(args)
    dev, u = loop.dev, loop.u

    def solve(u):
        _sync(dev)
        t0 = time.perf_counter()
        action, u = loop.solve(u)
        _sync(dev)
        return action, u, time.perf_counter() - t0

    for _ in range(WARMUP):
        action, u, _ = solve(u)
        loop.advance(action)
    walls, prof_walls = [], []
    for _ in range(args.steps):
        _, u, dt = solve(u)
        walls.append(dt)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=acts) as prof:
        for _ in range(args.steps):
            _, u, dt = solve(u)
            prof_walls.append(dt)
    solve_ms = 1e3 * sum(walls) / len(walls)
    profiled_ms = 1e3 * sum(prof_walls) / len(prof_walls)
    avg = prof.key_averages()
    device_ms = idle = None
    if dev.type == "cuda":
        device_us = sum(e.self_device_time_total for e in avg
                        if e.device_type == DeviceType.CUDA and not e.is_user_annotation)
        device_ms = device_us / 1e3 / args.steps
        idle = max(0.0, 1.0 - device_ms / solve_ms) if device_us > 0 else None
    # the host's CUDA runtime calls (the kernels launched through ctypes go
    # through cudaLaunchKernel as well)
    launches = sum(e.count for e in avg if e.key in ("cudaLaunchKernel", "cuLaunchKernel")
                   ) / args.steps
    memcpys = sum(e.count for e in avg if e.key.startswith("cudaMemcpy")) / args.steps
    host_top = avg.table(sort_by="self_cpu_time_total", row_limit=12)
    device_top = (avg.table(sort_by="self_device_time_total", row_limit=12)
                  if dev.type == "cuda" else "")
    if args.out:
        with open(args.out, "w") as f:
            f.write(avg.table(sort_by="self_cpu_time_total", row_limit=-1))
            if device_top:
                f.write("\n")
                f.write(avg.table(sort_by="self_device_time_total", row_limit=-1))
    log("%s%s solve profile: pop %d H %d iterations %d | %d solves | solve %.3f ms, "
        "%.3f ms under the profiler (host clock, synchronized) | device %s ms/solve | "
        "device idle share %s | per solve %.1f kernel launches, %.1f memcpys" % (
            args.task.upper(), " hybrid" if args.hybrid else "", args.population, args.horizon,
            args.iterations, args.steps,
            solve_ms, profiled_ms,
            "not measured" if device_ms is None else "%.3f" % device_ms,
            "not measured" if idle is None else "%.4f" % idle, launches, memcpys))
    return {"solve_ms": solve_ms, "profiled_solve_ms": profiled_ms,
            "device_ms": device_ms, "idle_share": idle, "launches_per_solve": launches,
            "memcpys_per_solve": memcpys, "host_top": host_top, "device_top": device_top}


def main(argv=None):
    out = profile_solve(parse_args(argv))
    print(out["host_top"])
    print(out["device_top"])
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
