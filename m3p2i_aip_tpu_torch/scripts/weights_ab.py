"""K2/K2b, the multi-modal weights kernel, against an earlier form of it on
one card, in one process: bits and times, in turns.

Builds each form from its own source with the port's nvcc flags into its
own library under ``m3p2i_aip_tpu_torch/_build/ab/`` (the before form from
``--parent``, the shipped ``csrc/multimodal_weights.cu``, and the shipped
source with constants replaced, ``--variant name=kConst:value,...``), plus
``weights_round_clock.cu``, a copy of the round-by-round form with clock64
stamps.  Then, on every input (the smoke's uniform(0, 50) costs, a tie, a
small group, K = 1500 and 4096, the seven panda parity costs, K1b's B = 20
costs, and with ``--record`` every weights call of the point main path, the
panda shelf run and the point and panda n=20 batches), it counts the
elements each form's weights differ from the before form's, and times
chosen inputs replayed from a CUDA graph in turns (before, forms..., forms
reversed, before).  The clock copy splits a round of the before form into
its parts.  Run on one GPU from the repository's root:

    python -m m3p2i_aip_tpu_torch.scripts.weights_ab --parent PATH/TO/multimodal_weights.cu [--record]

``--variant J4=kCandidates:4`` (repeatable) adds a form.  A JSON summary
goes to ``--out`` (default ``m3p2i_aip_tpu_torch/_build/ab/weights_ab.json``).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import subprocess
import sys

import numpy as np
import torch

from m3p2i_aip_tpu_torch.analysis import bench_record as br
from m3p2i_aip_tpu_torch.ops import cuda_build, weights

AB_DIR = cuda_build.BUILD_DIR / "ab"
CLOCK_SRC = pathlib.Path(__file__).resolve().with_name("weights_round_clock.cu")
CLOCK_PARTS = ("cost-to-go", "minima", "terms", "warp trees", "smem write + sync", "warp 0 tree + sync",
               "decision + sync", "final pass")
# the shipped form's parts, stamped by _instrumented on thread 0 of block 0
STEP_PARTS = ("cost-to-go", "minima", "terms + parent-warp trees", "syncwarp + candidate tree", "barrier", "walk",
              "output")
_STAMPS = (  # (anchor in the shipped source, text put before it)
    ("  // 2. the three masked minima", "  CLK(0);\n"),
    ("  // 3. the beta searches", "  CLK(1);\n"),
    ("    if (team == 1) {\n      __syncwarp();", "    CLK(2);\n"),
    ("    __syncthreads();\n    // each warp walks", "    CLK(3);\n"),
    ("    // each warp walks", "    CLK(4);\n"),
    ("    split = false;\n  }", "    CLK(5);\n    ++clk_steps;\n"),
)


def _instrumented(text: str) -> str:
    """The shipped source with clock64 stamps on thread 0 of block 0 (its
    parts in STEP_PARTS, the steps run) and a reader,
    ``m3p2i_weights_steps_read``."""
    for anchor, stamp in _STAMPS:
        assert text.count(anchor) == 1, anchor
        text = text.replace(anchor, stamp + anchor)
    head = "#include <math.h>\n"
    text = text.replace(head, head + "__device__ long long g_clk[8];\n#define CLK(i) do { const long long t_ = clock64(); "
                        "clk_acc[i] += t_ - clk_t; clk_t = t_; } while (0)\n")
    start = re.search(r"  const int tid = threadIdx.x[^\n]*\n", text).group(0)
    text = text.replace(start, start + "  long long clk_acc[7] = {0, 0, 0, 0, 0, 0, 0}, clk_t = clock64();\n  int clk_steps = 0;\n")
    end = "\n}\n\n}  // namespace"
    text = text.replace(end, "\n  CLK(6);\n  if (threadIdx.x == 0 && blockIdx.x == 0) {\n    for (int i = 0; i < 7; ++i) "
                        "g_clk[i] = clk_acc[i];\n    g_clk[7] = clk_steps;\n  }" + end)
    return text + ('\nextern "C" int m3p2i_weights_steps_read(long long* host) {\n'
                   "  return static_cast<int>(cudaMemcpyFromSymbol(host, g_clk, sizeof(g_clk)));\n}\n")


def _sources(parent: pathlib.Path, variants: list) -> dict:
    """{form: source text}: the before form, the shipped one, and each
    variant (the shipped source with ``constexpr ... kConst = value;``
    replaced)."""
    shipped = (cuda_build.CSRC_DIR / "multimodal_weights.cu").read_text()
    out = {"before": parent.read_text(), "shipped": shipped}
    for spec in variants:
        name, subs = spec.split("=", 1)
        text = shipped
        for sub in subs.split(","):
            const, value = sub.split(":")
            text, n = re.subn(rf"(constexpr \w+ {const} = )[^;]+;", rf"\g<1>{value};", text)
            assert n == 1, f"{name}: no constant {const} in the shipped source"
        out[name] = text
    out["stamped"] = _instrumented(shipped)
    return out


def _build(sources: dict) -> dict:
    """Each source compiled into its own library, all nvcc runs started
    together; returns {form: (ctypes library, ptxas report)}."""
    AB_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, text in list(sources.items()) + [("clock", CLOCK_SRC.read_text())]:
        src = AB_DIR / f"{name}.cu"
        src.write_text(text)
        lib = AB_DIR / f"lib_{name}.so"
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-shared", "-o", str(lib), str(src)]
        jobs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (lib, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        m = re.search(r"(\d+ bytes stack frame, \d+ bytes spill stores).*?Used (\d+) registers", log, re.S)
        built[name] = (ctypes.CDLL(str(lib)), f"{m.group(2)} registers, {m.group(1)}" if m else log.strip())
    return built


def _takes_scratch(text: str) -> bool:
    """Whether a form's entry point takes the global scratch pointer (the
    shipped form) or not (forms before it)."""
    return re.search(r"m3p2i_multimodal_weights\([^)]*float\* scratch", text) is not None


def _launcher(lib, scratch: bool):
    fn = lib.m3p2i_multimodal_weights
    sig = cuda_build._SIGNATURES["m3p2i_multimodal_weights"]
    fn.argtypes = sig if scratch else sig[:3] + sig[4:]
    fn.restype = ctypes.c_int

    def run(cost, gamma, half_K, eta_u, eta_l):
        c = cost if cost.dim() == 3 else cost[None]
        B, K, T = c.shape
        out = torch.empty(B, 3, K, dtype=torch.float32, device=c.device)
        ptrs = [c.data_ptr(), gamma.data_ptr(), out.data_ptr()]
        if scratch:
            tc = torch.empty(B, K, device=c.device) if K > weights.SMEM_MAX_K else None
            ptrs.append(None if tc is None else tc.data_ptr())
        err = fn(*ptrs, B, K, T, int(half_K), ctypes.c_float(eta_u),
                 ctypes.c_float(eta_l), torch.cuda.current_stream().cuda_stream)
        assert err == 0, f"launch failed: cudaError {err}"
        return out

    return run


def _clock(lib, args) -> dict:
    """The round-by-round form's parts on one [K, T] input: cycles of
    thread 0 in each part, the rounds, and the ns between its first and
    last stamp (median of 5 launches after 2)."""
    fn = lib.m3p2i_weights_clock
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_float] * 2 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    cost, gamma, half_K, eta_u, eta_l = args
    out = torch.empty(3, cost.shape[0], device="cuda")
    clocks = torch.zeros(11, dtype=torch.int64, device="cuda")
    reads = []
    for _ in range(7):
        assert fn(cost.data_ptr(), gamma.data_ptr(), out.data_ptr(), cost.shape[0], cost.shape[1], int(half_K),
                  ctypes.c_float(eta_u), ctypes.c_float(eta_l), clocks.data_ptr(),
                  torch.cuda.current_stream().cuda_stream) == 0
        torch.cuda.synchronize()
        reads.append(clocks.cpu().numpy().copy())
    c = np.median(np.stack(reads[2:]), axis=0)
    parts = dict(zip(CLOCK_PARTS, c[:8].tolist()))
    return {"cycles": parts, "rounds": int(c[8]), "ns": float(c[10] - c[9]), "cycles_total": float(c[:8].sum())}


def _differ(a, b) -> int:
    return int(torch.count_nonzero(a.contiguous().view(torch.int32) != b.contiguous().view(torch.int32)))


def _inputs(record: bool) -> dict:
    """{label: [args, ...]} with args = (cost, gamma, half_K, eta_u, eta_l)."""
    import chip_smoke as cs
    from m3p2i_aip_tpu_torch.config.config_store import load_config
    from m3p2i_aip_tpu_torch.ops import panda_rollout as pr
    from m3p2i_aip_tpu_torch.ops import rollout as ro
    from m3p2i_aip_tpu_torch.planners.motion_planner.mppi import make_task_params
    from m3p2i_aip_tpu_torch.tamp.reactive_tamp import ReactiveTAMP
    from m3p2i_aip_tpu_torch.utils.tree import tree_map

    tamp = ReactiveTAMP(load_config("config_point", cs.MAIN_PATH), device="cuda")
    mp = tamp.motion_planner
    rest = (mp.gamma_seq, mp.half_K, mp.eta_u, mp.eta_l)
    dev = lambda x: torch.as_tensor(np.asarray(x, np.float32), device="cuda")  # noqa: E731
    sets = {
        "random K=200": [(dev(np.random.default_rng(0).uniform(0, 50, size=(mp.K, mp.T))),) + rest],
        "tied K=200": [(dev(np.full((mp.K, mp.T), 1.43)),) + rest],
        "small group K=5": [(dev(np.random.default_rng(5).uniform(0, 50, size=(5, mp.T))), mp.gamma_seq, 2,
                             mp.eta_u, mp.eta_l)],
    }
    for K in (1500, 4096):
        sets[f"random K={K}"] = [(dev(np.random.default_rng(K).uniform(0, 50, size=(K, mp.T))), mp.gamma_seq, K // 2,
                                  mp.eta_u, mp.eta_l)]
    rng = np.random.default_rng(10)  # phase_point_batched's K1b inputs
    cs._point_batch_inputs(tamp, cs.CHECK_SEEDS, rng)
    x = cs._point_batch_inputs(tamp, cs.N_SEEDS, rng)
    sets["K1b costs B=20"] = [(ro.point_rollout_batched(mp.rollout.spec, *x)[0],) + rest]

    rng = np.random.default_rng(1)  # phase_panda_rollout's draws: multi_modal False, then True
    panda = []
    for mm in (False, True):
        ptamp = ReactiveTAMP(load_config("config_panda", [f"multi_modal={mm}"]), device="cuda")
        pmp, base = ptamp.motion_planner, ptamp.env.init_state()
        for name, start, task_name, grip, zup in pr.PARITY_CASES:
            goal = pr.PARITY_GOAL if task_name == "pick" else [0.0] * 7
            task = make_task_params(task_name, goal, "none", zup, device="cuda")
            acts = rng.uniform(-1.5, 1.5, size=(pmp.K, pmp.T, 9)).astype(np.float32)
            if grip is not None:
                acts[..., 7:9] = grip
            sk = tree_map(lambda v: v.expand((pmp.K,) + v.shape), pr.parity_state(base, start))
            if mm:
                c = pr.panda_rollout(pmp.rollout.spec, *pr.rollout_inputs(sk, task), dev(acts))[0]
                panda.append((c, pmp.gamma_seq, pmp.half_K, pmp.eta_u, pmp.eta_l))
    sets["panda parity x7"] = panda
    if record:
        with cs._recorded_weights("multimodal_weights") as calls:
            cs.phase_main_path(load_config("config_point", cs.MAIN_PATH))
        sets["point main path"] = list(calls)
        with cs._recorded_weights("multimodal_weights") as calls:
            cs.phase_panda_shelf()
        sets["panda shelf"] = list(calls)
        with cs._recorded_weights("multimodal_weights_batched") as calls:
            cs.phase_seed_batch("batch-point", "config_point", cs.MAIN_PATH, 4, 300,
                                {"rollout_batched_launches": 1, "weights_batched_launches": 1})
        sets["point n=20 batch"] = list(calls)
        with cs._recorded_weights("multimodal_weights_batched") as calls:
            cs.phase_seed_batch("batch-panda", "config_panda", ["multi_modal=True"], 10, 600,
                                {"panda_rollout_batched_launches": 4, "weights_batched_launches": 3,
                                 "panda_step_batched_launches": 1})
        sets["panda n=20 batch"] = list(calls)
    return sets


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=pathlib.Path, help="the before form's multimodal_weights.cu")
    ap.add_argument("--variant", action="append", default=[], help="name=kConst:value[,kConst:value]")
    ap.add_argument("--record", action="store_true", help="also every weights call of the four closed loops")
    ap.add_argument("--out", type=pathlib.Path, default=AB_DIR / "weights_ab.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("weights_ab: no CUDA device")
    card = br.nvidia_smi()
    print(f"[ab] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    sources = _sources(args.parent, args.variant)
    built = _build(sources)
    clock_lib = built.pop("clock")[0]
    stamped_lib = built.pop("stamped")[0]
    forms = {name: _launcher(lib, _takes_scratch(sources[name])) for name, (lib, _) in built.items()}
    for name, (_, report) in built.items():
        print(f"[ab] {name}: {report}")
    sets = _inputs(args.record)
    summary = {"card": card, "registers": {n: r for n, (_, r) in built.items()}, "inputs": {}}

    # bits: every input, every form against the before form
    for label, calls in sets.items():
        diff = {name: 0 for name in forms if name != "before"}
        elems = 0
        for a in calls:
            ref = forms["before"](*a)
            elems += ref.numel()
            for name in diff:
                diff[name] += _differ(forms[name](*a), ref)
        print(f"[ab] {label}: {len(calls)} calls, {elems} weights; elements that differ from the before form {diff}")
        summary["inputs"][label] = {"calls": len(calls), "differ": diff}

    # times: each recorded set's median over its calls and its slowest call (the before form's), then the
    # chosen inputs in turns
    order = list(forms) + list(forms)[::-1]
    timed = {label: calls[0] for label, calls in sets.items() if len(calls) == 1}
    for label, calls in sets.items():
        if len(calls) == 1:
            continue
        med = {}
        for name in forms:
            t = [br.replayed_ms(lambda: forms[name](*a), launches=10, reps=3) for a in calls]
            med[name] = float(np.median(t))
            if name == "before":
                timed[f"{label}, slowest"] = calls[int(np.argmax(t))]
        print(f"[ab] {label}: median over {len(calls)} calls, replayed ms {med} ({card})")
        summary["inputs"][label]["median_device_ms"] = med
    for label, a in timed.items():
        reads = {name: [] for name in forms}
        for name in order:
            reads[name].append(br.replayed_ms(lambda: forms[name](*a)))
        single = {name: br.event_ms(lambda: forms[name](*a)) for name in ("before", "shipped")}
        rounds = None
        if a[0].shape[-2] >= 2:
            rounds = weights.beta_rounds(*a)[0].reshape(-1, 3).max(0).tolist()
        print(f"[ab] {label} {tuple(a[0].shape)}, most rounds {rounds}: replayed ms in turns {reads}; single ms "
              f"{single} ({card})")
        summary["inputs"].setdefault(label, {}).update({"device_ms": reads, "single_ms": single, "rounds": rounds})

    # the before form's round, in parts; an empty kernel
    for label in ("random K=200", "tied K=200", "point main path, slowest", "panda shelf, slowest"):
        if label in timed and timed[label][0].dim() == 2:
            c = _clock(clock_lib, timed[label])
            per = {k: round(v / max(c["rounds"], 1), 1) for k, v in c["cycles"].items()}
            print(f"[ab] clock, {label}: {c['rounds']} rounds, {c['cycles_total']:.0f} cycles in {c['ns']:.0f} ns; "
                  f"cycles {c['cycles']}; a round's parts {per} ({card})")
            summary.setdefault("clock", {})[label] = c
    # the shipped form's step, in parts
    read = stamped_lib.m3p2i_weights_steps_read
    read.argtypes, read.restype = [ctypes.c_void_p], ctypes.c_int
    stamped = _launcher(stamped_lib, _takes_scratch(sources["stamped"]))
    for label in ("random K=200", "tied K=200", "K1b costs B=20", "point main path, slowest", "panda shelf, slowest"):
        if label not in timed:
            continue
        reads = []
        for _ in range(7):
            stamped(*timed[label])
            torch.cuda.synchronize()
            host = (ctypes.c_longlong * 8)()
            assert read(host) == 0
            reads.append(list(host))
        c = np.median(np.asarray(reads[2:], dtype=np.float64), axis=0)
        steps = max(int(c[7]), 1)
        parts = dict(zip(STEP_PARTS, c[:7].tolist()))
        per = {k: round(parts[k] / steps, 1) for k in STEP_PARTS[2:6]}
        print(f"[ab] shipped form, clock, {label} (block 0): {steps} steps, {c[:7].sum():.0f} cycles; cycles {parts}; "
              f"a step's parts {per} ({card})")
        summary.setdefault("step_clock", {})[label] = {"steps": steps, "cycles": parts}
    empty = {"single_ms": br.event_ms(lambda: torch.cuda._sleep(0)),
             "device_ms": br.replayed_ms(lambda: torch.cuda._sleep(0))}
    print(f"[ab] an empty kernel (torch.cuda._sleep(0)): {empty} ({card})")
    summary["empty_kernel"] = empty
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(summary, indent=1))
    print(f"[ab] summary in {args.out}")


if __name__ == "__main__":
    main()
