"""The compiled tick against the eager tick on one card: bits, capture cost,
rates and device idle shares, in one process.

1. Parity: each run twice from one config, seed and warm-up, eagerly
   (``graphs=False``) and compiled (the default: a CUDA graph a tick,
   replayed), every chunk's outputs (views, n_ticks and done; the panda's
   stages and dones) and the final carry compared bit for bit: the point
   main path gated (chunks of 50, the latch at tick 47), the point in
   benchmark mode (gates off, two chunks of 25), the point per tick (``SimLoop.run``, the
   ``run_tamp`` script's loop), the panda table pick-place gated (chunks of
   50, the latch at 83), the albert push_reach gated (chunks of 10) and the
   n=20 point, panda and albert batches (``BatchSimLoop``, chunks of 4, 10
   and 10).
   Then the paths whose programs are compiled besides the tick: the
   gradient-refined panda (the round-4 setting, ``REFINED``: three graphs a
   tick, one gradient step replayed ``grad_refine_steps`` times), the gated
   main path over 8 shards of one card (``SHARDED``: each shard's rollout a
   branch of the graph), and the two terminals in process
   (``TWO_TERMINAL``: ``scripts/sim.py``'s ``drive`` against a
   ``ReactiveTAMPServer``, the client's steps and the server's command
   compiled; every view sent, action returned and the final states).
2. Each graph's capture time, node count, memory pool and launches a replay
   (a segmented tick: each segment's nodes, replays and capture time).
3. K2 at K = 16384 (the cost-to-go in opted-in shared memory): a launch
   captured into a CUDA graph against an eager launch, and with
   ``parent=PATH`` against the earlier source's launch (built here with the
   port's nvcc flags), bit for bit.
4. Rates in turns (eager, compiled, compiled, eager; one loop a mode),
   both gates off: the
   point main path in serial and pipelined chunks of 50 and per tick, the
   B=20 point batch's batched tick, the panda, the albert and the north-star
   shape (K=500 x T=30) in serial chunks; then ``torch.profiler`` over a
   chunk of each mode (device time and idle share a tick), but for the
   pipelined and per-tick rates, whose device tick is the serial one's;
   each of the port's kernels appears in the trace as many times as its
   wrappers launched it (eager) or its graph replays did (compiled).  The
   main path over 8 shards is a rate of the list.
5. Turns (eager, compiled, compiled, eager) of what is not a chunked rate:
   the two terminals in process (the client's whole tick and its
   ``run_tamp`` call, medians), ``SimLoop.warmup(150)`` and a 150-step
   panda settle (seconds), and the gradient-refined panda tick (seconds).

    python -m m3p2i_aip_tpu_torch.scripts.graph_ab [parent=PATH/multimodal_weights.cu] [out=PATH|-] [--quick | tail=N]

``--quick`` runs the parity and the capture stats only; ``tail=N`` only
profiles the eager north-star chunk N times without and with
``bench_record.profile``'s pads, in turns (where the profiler loses
events).  Prints one line
per check and per rate with the card's name and power limit, and one JSON
line, written to ``results_h100/bench/GRAPH_AB.json``.  Needs a card.
"""
from __future__ import annotations

import ctypes
import dataclasses
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

from m3p2i_aip_tpu_torch.analysis import bench_record as br
from m3p2i_aip_tpu_torch.config.config_store import load_config
from m3p2i_aip_tpu_torch.parallel import make_mesh, shard_planner
from m3p2i_aip_tpu_torch.scripts import bench, bench_albert, bench_northstar, bench_panda
from m3p2i_aip_tpu_torch.scripts.bench import MAIN_PATH
from m3p2i_aip_tpu_torch.scripts.run_tamp import pop_option
from m3p2i_aip_tpu_torch.scripts.sim import drive
from m3p2i_aip_tpu_torch.tamp.batch_loop import BatchSimLoop
from m3p2i_aip_tpu_torch.tamp.reactive_tamp import ReactiveTAMPServer
from m3p2i_aip_tpu_torch.tamp.sim_loop import SimLoop

PUSH_REACH = ["task=push_reach", "goal=[3.0,0.0,0.6]"]
# (label, config, overrides, warm-up, ticks, chunk, gated): the parity runs of single loops
LOOPS = [
    ("point gated", "config_point", MAIN_PATH, 50, 1000, 50, True),
    ("point benchmark", "config_point", MAIN_PATH, 50, 50, 25, False),
    ("panda gated", "config_panda", [], 50, 900, 50, True),
    ("albert push_reach", "config_albert", PUSH_REACH, 20, 500, 10, True),
]
PER_TICK = 60  # the per-tick parity run's ticks, gated
# (label, config, overrides, chunk, tick cap): the n=20 batches
BATCHES = [
    ("point batch", "config_point", MAIN_PATH, 4, 300),
    ("panda batch", "config_panda", ["multi_modal=True"], 10, 600),
    ("albert batch", "config_albert", [], 10, 300),
]
N_SEEDS = 20
# the round-4 panda setting (config/mppi/panda.yaml:25-32): eight gradient steps on the plain chain
GRAD_REFINE = ["multi_modal=True", "mppi.grad_refine_steps=8", "mppi.grad_refine_unroll=True", "mppi.refine_iters=0"]
# (label, config, overrides, warm-up, ticks, chunk, gated, shards): the compiled planner's other paths
REFINED = ("panda grad-refine", "config_panda", GRAD_REFINE, 50, 2, 1, True, 0)
SHARDED = ("point x8 shards", "config_point", MAIN_PATH, 50, 1000, 50, True, 8)
# (label, config, overrides, ticks): the two terminals in process
TWO_TERMINAL = [
    ("two-terminal point", "config_point", ["task=push", "goal=[-1,-1]"], 60),
    ("two-terminal panda", "config_panda", [], 20),
    ("two-terminal albert", "config_albert", [], 20),
]
TURN_TICKS = 20  # the two terminals' ticks a turn
STEPS = 150  # the warm-up's and the settle's steps a turn
RATE_CHUNK, RATE_TIMED = 50, 100  # the rates: 2 chunks to settle, then these timed ticks
PROFILE_TICKS = 5  # a profiled chunk's ticks (an eager point tick is ~4,700 kernel events)


def record_chunks(loop) -> list:
    """Wrap the loop's chunk entries (point family and panda) to keep each
    chunk's tensor outputs past its carry on the host, its views first
    ([..., length, nv]), beside the loop (read after the run)."""
    out, tamp = [], loop.tamp
    for name, views_at in (("_run_chunk_impl", 2), ("_run_chunk_panda_impl", 5)):
        fn = getattr(tamp, name)

        def recorded(*args, fn=fn, views_at=views_at, **kwargs):
            res = fn(*args, **kwargs)
            rest = [x for i, x in enumerate(res[2:], 2) if torch.is_tensor(x) and i != views_at]
            out.append([x.cpu().numpy() for x in [res[views_at], *rest]])
            return res

        setattr(tamp, name, recorded)
    return out


def record_ticks(loop) -> list:
    """Wrap ``tick_fused`` to keep each tick's action and view on the host."""
    out, fn = [], loop.tamp.tick_fused

    def recorded(*args):
        res = fn(*args)
        out.append([res[0].cpu().numpy(), res[3].cpu().numpy()])
        return res

    loop.tamp.tick_fused = recorded
    return out


def carry_fields(*states) -> dict:
    """{name: host array} of the fields of the given state dataclasses."""
    return {f"{type(s).__name__}.{f.name}": getattr(s, f.name).cpu().numpy()
            for s in states for f in dataclasses.fields(s) if torch.is_tensor(getattr(s, f.name))}


def differ(a, b) -> list:
    """What differs between two records (lists of arrays, or dicts of them):
    paths to the first differences, empty when bit-equal."""
    if isinstance(a, dict):
        keys = sorted(set(a) | set(b))
        return [p for k in keys for p in ([k] if k not in a or k not in b else [f"{k}/{q}" for q in differ(a[k], b[k])])]
    if isinstance(a, (list, tuple)):
        if len(a) != len(b):
            return [f"length {len(a)} != {len(b)}"]
        return [f"{i}/{p}" for i, (x, y) in enumerate(zip(a, b)) for p in differ(x, y)]
    x, y = np.asarray(a), np.asarray(b)
    if x.dtype == object or y.dtype == object:  # None or mixed entries: compare as values
        return [] if a == b else [f"{a!r} vs {b!r}"]
    same = x.shape == y.shape and x.dtype == y.dtype and x.tobytes() == y.tobytes()
    return [] if same else [f"{x.dtype}{x.shape} vs {y.dtype}{y.shape}"]


def log_record(log) -> dict:
    return {"steps": log.steps, "success_step": log.success_step, "task": list(log.task),
            **{n: np.asarray(getattr(log, n)) for n in ("robot_pos", "robot_vel", "box_pos")}}


def run_loop(config_name: str, overrides: list, graphs, warmup: int, ticks: int, chunk: int, gated: bool,
             per_tick: bool = False, device="cuda", shards: int = 0) -> dict:
    """One run of a single loop (its planner's samples split over ``shards``
    shards of ``device`` when nonzero); returns its record (chunk or tick
    outputs, log, final carry) and the loop."""
    loop = SimLoop(load_config(config_name, overrides), device=device, graphs=graphs)
    if shards:
        shard_planner(loop.tamp.motion_planner, make_mesh([torch.device(device)] * shards))
    loop.warmup(warmup)
    if not gated:
        br.gates_off(loop)
    rec = record_ticks(loop) if per_tick else record_chunks(loop)
    if per_tick:
        loop.run(ticks)
    else:
        loop.run_chunked(ticks, chunk=chunk)
    return loop_record(loop, rec)


def loop_record(loop, outputs: list) -> dict:
    """A finished single loop's record: its recorded outputs, log and final
    carry (planner and env state)."""
    br.synchronize(loop.env.device)
    return {"outputs": outputs, "log": log_record(loop.log),
            "carry": carry_fields(loop.tamp.mppi_state, loop.state), "loop": loop}


def batch_record(batch, outputs: list, logs: list) -> dict:
    """A finished batch's record: its recorded outputs, every seed's log and
    the final carry (the panda's stage and stall carry too)."""
    br.synchronize(batch.device)
    sh = batch._shards[0]
    carry = carry_fields(sh.mppi_state, sh.state)
    if sh.stage is not None:
        carry.update(stage=sh.stage.cpu().numpy(), zs=sh.zs.cpu().numpy())
    return {"outputs": outputs, "log": [log_record(g) for g in logs], "carry": carry, "loop": batch}


def run_batch(config_name: str, overrides: list, graphs, chunk: int, cap: int, device="cuda",
              n_seeds: int = N_SEEDS) -> dict:
    batch = BatchSimLoop(load_config(config_name, overrides), list(range(n_seeds)), device=device, graphs=graphs)
    batch.warmup(20)
    rec = record_chunks(batch)
    return batch_record(batch, rec, batch.run_chunked(cap, chunk=chunk))


def run_two_terminal(config_name: str, overrides: list, graphs, ticks: int, device="cuda") -> dict:
    """The two terminals in one process: ``drive`` (pacing off) against a
    ``ReactiveTAMPServer`` called directly, both with ``graphs``.  Returns
    its record (every tick's dof and root views sent and action returned;
    the final planner and env states), the server as ``loop``, and each
    tick's ``run_tamp`` and whole-tick seconds."""
    server = ReactiveTAMPServer(load_config(config_name, overrides), device=device, graphs=graphs)
    sent = []

    class Recorder:
        def run_tamp(self, dof, root):
            action = server.run_tamp(dof, root)
            sent.append([np.array(dof), np.array(root), np.asarray(action)])
            return action

        get_suction, get_trajs = server.get_suction, server.get_trajs

    env, state, rpc_s, tick_s = drive(load_config(config_name, overrides), Recorder(), n_ticks=ticks, pace=False,
                                      device=device, graphs=graphs)
    br.synchronize(env.device)
    return {"outputs": sent, "log": {"ticks": len(tick_s)}, "carry": carry_fields(server.tamp.mppi_state, state),
            "loop": server, "rpc_s": rpc_s, "tick_s": tick_s}


def parity(label: str, eager: dict, compiled: dict) -> dict:
    """Compare an eager and a compiled run's records; raises unless bit-equal."""
    diffs = {k: differ(eager[k], compiled[k]) for k in ("outputs", "log", "carry")}
    logs = compiled["log"] if isinstance(compiled["log"], list) else [compiled["log"]]
    steps = [g.get("success_step") for g in logs]
    tamp = compiled["loop"].tamp
    graphs = tamp.ticks.stats()
    print(f"[graph-parity {label}] chunks/ticks {len(compiled['outputs'])}, success ticks {steps}; differences from "
          f"the eager run: {sum(len(d) for d in diffs.values())} {[(k, d[:3]) for k, d in diffs.items() if d]}")
    for g in graphs:
        segments = "" if len(g["segments"]) == 1 else "; segments (nodes x replays, capture ms) " + ", ".join(
            f"{x['nodes']} x {x['replays']} ({x['capture_s'] * 1e3:.1f})" for x in g["segments"])
        print(f"[graph-capture {label}] {g['key']}: capture {g['capture_s'] * 1e3:.1f} ms, {g['nodes']} nodes, pool "
              f"{g['pool_bytes'] / 2**20:.2f} MiB, launches a replay {g['launches']}, replays {g['replays']}{segments}")
    assert graphs or tamp.ticks.mode != "graph", f"{label}: the compiled run captured no graph"
    assert not any(diffs.values()), f"{label}: the compiled run differs from the eager run: {diffs}"
    return {"label": label, "success": steps, "graphs": graphs}


def check_parity(device="cuda", extra=(), cap=None, n_seeds: int = N_SEEDS) -> list:
    """Every parity run (see the module docstring), each eager then
    compiled; ``extra`` overrides every config, ``cap`` caps every run's
    ticks (a CPU rehearsal at a small size)."""
    modes = (False, None)  # eager, then the default: a CUDA graph on the card, the static-buffer tick on the CPU
    out = []
    for label, config_name, overrides, warmup, ticks, chunk, gated in LOOPS:
        runs = [run_loop(config_name, [*overrides, *extra], g, warmup, min(ticks, cap or ticks), chunk, gated,
                         device=device) for g in modes]
        out.append(parity(label, *runs))
    runs = [run_loop("config_point", [*MAIN_PATH, *extra], g, 50, min(PER_TICK, cap or PER_TICK), 1, True,
                     per_tick=True, device=device) for g in modes]
    out.append(parity("point per tick", *runs))
    for label, config_name, overrides, chunk, ticks in BATCHES:
        runs = [run_batch(config_name, [*overrides, *extra], g, chunk, min(ticks, cap or ticks), device, n_seeds)
                for g in modes]
        out.append(parity(label, *runs))
    for label, config_name, overrides, warmup, ticks, chunk, gated, shards in (REFINED, SHARDED):
        runs = [run_loop(config_name, [*overrides, *extra], g, warmup, min(ticks, cap or ticks), chunk, gated,
                         device=device, shards=shards) for g in modes]
        out.append(parity(label, *runs))
    for label, config_name, overrides, ticks in TWO_TERMINAL:
        runs = [run_two_terminal(config_name, [*overrides, *extra], g, min(ticks, cap or ticks), device)
                for g in modes]
        out.append(parity(label, *runs))
    return out


def _parent_weights(path: pathlib.Path):
    """The earlier weights source built with the port's flags into its own
    library; returns its launcher (inputs as ``multimodal_weights``'s)."""
    from m3p2i_aip_tpu_torch.ops import cuda_build, weights

    out_dir = cuda_build.BUILD_DIR / "graph_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / "lib_parent_weights.so"
    subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-shared", "-o", str(lib_path), str(path)],
                   check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(lib_path)).m3p2i_multimodal_weights
    fn.argtypes, fn.restype = cuda_build._SIGNATURES["m3p2i_multimodal_weights"], ctypes.c_int

    def run(cost, gamma, half_K, eta_u, eta_l):
        K, T = cost.shape
        out = torch.empty(1, 3, K, dtype=torch.float32, device=cost.device)
        assert K <= weights.SMEM_MAX_K
        err = fn(cost.data_ptr(), gamma.data_ptr(), out.data_ptr(), None, 1, K, T, int(half_K), ctypes.c_float(eta_u),
                 ctypes.c_float(eta_l), torch.cuda.current_stream().cuda_stream)
        assert err == 0, f"parent launch failed: cudaError {err}"
        return out[0]

    return run


def check_weights_captured(parent=None, K: int = 16384) -> dict:
    """K2 at ``K`` on uniform(0, 50) costs (the smoke's large-K inputs): an
    eager launch, the same launch replayed from a CUDA graph, and the
    parent's launch, bit for bit."""
    from m3p2i_aip_tpu_torch.ops import weights

    gamma = torch.as_tensor(np.cumprod([1.0] + [0.95] * 14).astype(np.float32), device="cuda")
    cost = torch.as_tensor(np.random.default_rng(K).uniform(0, 50, size=(2, K, 15)).astype(np.float32), device="cuda")
    args = (cost[0], gamma, K // 2, 10.0, 3.0)
    eager = torch.stack(weights.multimodal_weights(*args))
    static_out = torch.empty_like(eager)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static_out.copy_(torch.stack(weights.multimodal_weights(*args)))
    static_out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    res = {"K": K, "captured_equal": bool(torch.equal(static_out, eager))}
    if parent is not None:
        res["parent_equal"] = bool(torch.equal(_parent_weights(pathlib.Path(parent))(*args), eager))
    print(f"[graph-weights] K2 at K={K}: captured launch bit-equal to the eager launch {res['captured_equal']}; "
          f"to the parent source's launch {res.get('parent_equal', 'not run')}")
    assert res["captured_equal"] and res.get("parent_equal", True), res
    return res


# ------------------------------------------------------------------ rates
def _loop(cfg, graphs, warmup: int = 50) -> SimLoop:
    loop = SimLoop(cfg, device="cuda", graphs=graphs)
    loop.warmup(warmup)
    return loop


def _twin(twin, warmup: int = 50, pipelined: bool = False):
    """(make, measure) of a bench twin's config and its ``measure``."""
    def measure(loop, chunk: int, timed: int) -> float:
        return twin.measure(loop, chunk, timed, *((pipelined,) if twin is bench else ()))["value"]

    return (lambda graphs: _loop(twin.config(), graphs, warmup)), measure


def _per_tick_loop(graphs) -> SimLoop:
    loop = _loop(bench.config(), graphs)
    br.gates_off(loop)
    return loop


def _per_tick(loop, chunk: int, timed: int) -> float:
    """``SimLoop.run``'s ticks a second (a replan, a step and the host
    planner on one fetched view a tick), gates off, after 5 untimed."""
    loop.run(5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loop.run(timed)
    torch.cuda.synchronize()
    return timed / (time.perf_counter() - t0)


def _batch(graphs) -> BatchSimLoop:
    """The B=20 point batch in benchmark mode, its tasks planned once."""
    batch = BatchSimLoop(load_config("config_point", MAIN_PATH), list(range(N_SEEDS)), device="cuda", graphs=graphs)
    batch.warmup(50)
    for b, tp in enumerate(batch.planners):
        tp.update_plan(batch.views[b])
    task, tamp = batch._stacked_task_params(), batch.tamp
    batch.bench_i0 = 0

    def run(n_chunks):  # the batch's own chunk loop, gates off, each chunk's views fetched
        for _ in range(n_chunks):
            batch.mppi_state, batch.state, views, _, _ = tamp._run_chunk_impl(
                batch.mppi_state, batch.state, task, batch.bench_i0, 10, gate=False)
            batch.bench_i0 += 10
            views.cpu()

    batch.bench_run = run
    batch.profile_run = lambda: tamp._run_chunk_impl(batch.mppi_state, batch.state, task, 0, PROFILE_TICKS,
                                                     gate=False)
    return batch


def _batched(batch, chunk: int, timed: int) -> float:
    """Batched ticks a second of the B=20 point batch in chunks of 10,
    after 2 untimed chunks."""
    n = max(1, timed // 10)
    batch.bench_run(2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batch.bench_run(n)
    return 10 * n / (time.perf_counter() - t0)


def _sharded(graphs) -> SimLoop:
    """The main path's loop in benchmark mode over 8 shards of the card."""
    loop = SimLoop(bench.config(), device="cuda", graphs=graphs)
    shard_planner(loop.tamp.motion_planner, make_mesh([torch.device("cuda", 0)] * SHARDED[-1]))
    loop.warmup(50)
    return loop


# name: ((make(graphs) -> loop, measure(loop, chunk, timed) -> Hz), {profile label: a substring of the kernel's
# name}, or None: not profiled, the same device tick as "point serial")
RATES = {
    "point serial": (_twin(bench), {"K1": "point_rollout", "K2": "weights"}),
    "point pipelined": (_twin(bench, pipelined=True), None),
    "point per tick": ((_per_tick_loop, _per_tick), None),
    "point B=20 batched tick": ((_batch, _batched), {"K1b": "point_rollout", "K2b": "weights"}),
    "panda serial": (_twin(bench_panda), {"K3": "panda_rollout", "K2": "weights"}),
    "albert serial": (_twin(bench_albert, warmup=20), {"K4": "albert_rollout"}),
    "north-star serial": (_twin(bench_northstar), {"K1": "point_rollout", "K2": "weights"}),
    "point x8 shards serial": ((_sharded, _twin(bench)[1]), {"K1": "point_rollout", "K2": "weights"}),
}


def _profile_of(loop):
    """One profiled chunk of PROFILE_TICKS of the loop's own tick, gates off
    (its graph, when compiled, captured by the rate before)."""
    if hasattr(loop, "profile_run"):
        return loop.profile_run
    if loop.env.env_type == "panda_env":
        tamp = loop.tamp
        return lambda: tamp.run_chunk_panda(tamp.mppi_state, loop.state, 0, tamp.zup_zs0(), PROFILE_TICKS)
    return lambda: loop.run_chunked(PROFILE_TICKS, chunk=PROFILE_TICKS)


def _traced_profile(loop, kernels: dict, label: str):
    """``br.profile`` of one chunk of the loop whose kernel events equal the
    launches its wrappers counted and its graph replays made while it ran
    (``br.traced_launches``).  A trace short of some events is taken once
    more, said in one line with the differing kernels' event times (the
    profiler has lost one tick's events of an eager chunk on the card); a
    second difference raises.  A trace that kept every kernel of the run but
    not all of ``br.profile``'s pads is said in a line too."""
    for attempt in range(2):
        before = br.launch_counts()
        prof = br.profile(_profile_of(loop), PROFILE_TICKS, kernels)
        if prof is None:
            return None
        diff = br.traced_launches(prof, before)
        if not diff and min(prof["pad_traced"]) < prof["pad"]:
            print(f"[graph-trace {label}] a pad took a loss: {_trace_line(prof, diff)}", flush=True)
        if not diff:
            return prof
        print(f"[graph-trace {label}] {_trace_line(prof, diff)}", flush=True)
    raise AssertionError(f"{label}: the profiled kernel events differ from the launches twice: {diff}")


def _trace_line(prof: dict, diff: dict) -> str:
    """A profile's kernel events against the launches counted: the kernels
    that differ, their events' start times, the last device event's end,
    the pads' events kept and the gaps between the pads and the run."""
    starts = {sym: prof["kernel_starts_ms"][sym] for sym in diff}
    (head, tail), (gap_head, gap_tail) = prof["pad_traced"], prof["pad_gaps_ms"]
    return (f"kernel events (traced, counted) differ: {diff or 'none'}; their start times, ms from the first device "
            f"event: {starts}, the last device event's end {prof['device_span_ms']} ms; pads: {head} and {tail} of "
            f"{prof['pad']} events kept before and after the run, {gap_head} ms and {gap_tail} ms from it")


def trace_tail(card: str, name: str = "north-star serial", rounds: int = 6) -> dict:
    """Where the profiler loses kernel events: the rate ``name``'s eager
    loop (the north-star chunk, whose profiles have traced 4 of 5 ticks' K1
    and K2 events) profiled ``rounds`` times without ``br.profile``'s pads
    and with them, in turns; each profile's kernels whose events differ
    from the launches counted, by pad."""
    (make, measure), kernels = RATES[name]
    loop = make(False)
    measure(loop, RATE_CHUNK, RATE_CHUNK)
    out = {0: [], br.PAD: []}
    for i in range(rounds):
        for pad in out:
            before = br.launch_counts()
            prof = br.profile(_profile_of(loop), PROFILE_TICKS, kernels, pad=pad)
            diff = br.traced_launches(prof, before)
            out[pad].append({sym: list(d) for sym, d in diff.items()})
            print(f"[graph-tail {name} eager, round {i}, pad {pad}] {_trace_line(prof, diff)} ({card})", flush=True)
    lost = {pad: sum(bool(d) for d in diffs) for pad, diffs in out.items()}
    print(f"[graph-tail {name} eager] profiles that lost kernel events, by pad: {lost} of {rounds} each ({card})",
          flush=True)
    return {"rate": name, "rounds": rounds, "lost": {str(k): v for k, v in lost.items()},
            "diffs": {str(k): v for k, v in out.items()}}


def paired_rates(card: str, names=tuple(RATES), chunk: int = RATE_CHUNK, timed: int = RATE_TIMED) -> dict:
    """Each rate eager and compiled in turns (eager, compiled, compiled,
    eager) on one loop a mode, ``timed`` ticks after two chunks of
    ``chunk`` a turn, then one profiled chunk of each mode: kernels, device
    time and wall a tick, the idle share, and the named kernels' device time
    a tick."""
    out = {}
    for name in names:
        (make, measure), kernels = RATES[name]
        loops = {graphs: make(graphs) for graphs in (False, True)}
        hz = {False: [], True: []}
        for graphs in (False, True, True, False):  # each turn on the mode's one loop, from where it stands
            hz[graphs].append(measure(loops[graphs], chunk, timed))
        prof = {}
        for graphs, mode in ((False, "eager"), (True, "compiled")) if kernels is not None else ():
            prof[mode] = _traced_profile(loops[graphs], kernels, f"{name} {mode}")
        graphs = loops[True].tamp.ticks.stats()
        assert graphs and loops[False].tamp.ticks.mode == "eager", name
        out[name] = {"eager_hz": hz[False], "compiled_hz": hz[True], "profile": prof, "graphs": graphs}
        fmt = lambda xs: " / ".join(f"{x:.2f}" for x in xs)  # noqa: E731
        line = "; ".join(f"{m}: {p['kernels_per_tick']:.0f} kernels, {p['device_ms_per_tick']:.3f} ms device ("
                         + ", ".join(f"{k} {v:.3f}" for k, v in p["kernel_ms_per_tick"].items())
                         + f"), {p['wall_ms_per_tick']:.3f} ms wall a tick, idle {p['idle_pct']:.1f}%"
                         if p else f"{m}: device time not measured" for m, p in prof.items())
        line = f"; profiled {PROFILE_TICKS} ticks: {line}" if prof else ""
        print(f"[graph-rate {name}] eager {fmt(hz[False])} Hz, compiled {fmt(hz[True])} Hz (in turns e, c, c, e; "
              f"{timed} timed ticks after 2 chunks of {chunk}){line} ({card})", flush=True)
    return out


def _turns(run) -> dict:
    """``run(graphs)`` in turns: eager, compiled, compiled, eager; its
    results by mode."""
    out = {"eager": [], "compiled": []}
    for graphs in (False, None, None, False):
        out["eager" if graphs is False else "compiled"].append(run(graphs))
    return out


def two_terminal_turns(card: str, ticks: int = TURN_TICKS) -> dict:
    """The two terminals in process, each family ``ticks`` ticks a turn:
    the medians of the client's whole tick and of its ``run_tamp`` call, ms."""
    out = {}
    for label, config_name, overrides, _ in TWO_TERMINAL:
        def run(graphs):
            rec = run_two_terminal(config_name, overrides, graphs, ticks)
            return float(np.median(rec["tick_s"])) * 1e3, float(np.median(rec["rpc_s"])) * 1e3

        out[label] = _turns(run)
        fmt = lambda xs: " / ".join(f"{t:.2f} ({r:.2f})" for t, r in xs)  # noqa: E731
        print(f"[graph-turns {label}] client tick (run_tamp) ms, medians of {ticks} ticks: eager "
              f"{fmt(out[label]['eager'])}, compiled {fmt(out[label]['compiled'])} (in turns e, c, c, e; {card})",
              flush=True)
    return out


def step_turns(card: str, n: int = STEPS) -> dict:
    """``SimLoop.warmup(n)`` of the point and the panda and a panda
    ``settle(n)``, seconds a turn, each turn on a fresh loop (a compiled
    turn's first step captures the step's graph: ``capture_s``)."""
    out = {}
    for label, config_name, method in (("point warmup", "config_point", "warmup"),
                                       ("panda warmup", "config_panda", "warmup"),
                                       ("panda settle", "config_panda", "settle")):
        captures = []

        def run(graphs):
            loop = SimLoop(load_config(config_name), device="cuda", graphs=graphs)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            getattr(loop, method)(n)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            captures.extend(g["capture_s"] for g in loop.tamp.ticks.stats())
            return wall

        out[label] = dict(_turns(run), capture_s=captures)
        fmt = lambda xs: " / ".join(f"{x:.4f}" for x in xs)  # noqa: E731
        print(f"[graph-turns {label}] {n} steps, s: eager {fmt(out[label]['eager'])}, compiled "
              f"{fmt(out[label]['compiled'])} (in turns e, c, c, e; of each compiled turn the capture "
              f"{fmt(captures)}; {card})", flush=True)
    return out


def grad_refine_turns(card: str, ticks: int = REFINED[4]) -> dict:
    """The gradient-refined panda (``REFINED``), ``ticks`` gated ticks a
    turn after its warm-up, seconds a tick (a compiled turn's first tick
    runs eagerly and captures), with each compiled turn's graphs."""
    _, config_name, overrides, warmup, _, _, _, _ = REFINED
    graphs_seen = []

    def run(graphs):
        loop = _loop(load_config(config_name, overrides), graphs, warmup)
        tick_s = []
        for _ in range(ticks + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loop.run_chunked(1, chunk=1)
            torch.cuda.synchronize()
            tick_s.append(time.perf_counter() - t0)
        graphs_seen.append(loop.tamp.ticks.stats())
        return tick_s

    out = dict(_turns(run), graphs=[g for g in graphs_seen if g])
    fmt = lambda xs: " / ".join(", ".join(f"{t:.4f}" for t in x) for x in xs)  # noqa: E731
    print(f"[graph-turns panda grad-refine] tick s (the first of each turn warms up or captures): eager "
          f"{fmt(out['eager'])}; compiled {fmt(out['compiled'])} (in turns e, c, c, e; {card})", flush=True)
    return out


def main(argv) -> dict:
    out, argv = pop_option(argv, "out", None)
    parent, argv = pop_option(argv, "parent", None)
    br.require_device("cuda", "graph_ab")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = br.nvidia_smi()
    print(f"[graph-ab] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    tail, argv = pop_option(argv, "tail", None)
    if tail is not None:
        rec = {"tail": trace_tail(card, rounds=int(tail))}
    else:
        rec = {"weights": check_weights_captured(parent), "parity": check_parity()}
    if tail is None and "--quick" not in argv:
        rec["rates"] = paired_rates(card)
        rec["turns"] = {"two_terminal": two_terminal_turns(card), "steps": step_turns(card),
                        "grad_refine": grad_refine_turns(card)}
    dev = br.device_record(torch.device("cuda"))
    rec.update(platform=dev["platform"], device=dev)
    br.emit(rec, "GRAPH_AB.json" if tail is None else "GRAPH_TAIL.json", out)
    return rec


if __name__ == "__main__":
    main(sys.argv[1:])
