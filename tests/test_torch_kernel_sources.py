"""The constants each CUDA source shares with its Python wrapper, read from
the sources themselves (no nvcc needed): compile-time maxima, the scalar
count of each param buffer and the row strides the wrapper's
``_param_buffer`` writes, the albert's state and action widths, the beta
search's round cap, and the team kernels' widths.  A source edited
without its wrapper (or the other way round) fails here, on the CPU, before
a launch on the card reads a misaligned buffer."""
import re

import numpy as np
import pytest

from m3p2i_aip_tpu_torch.config.config_store import load_config
from m3p2i_aip_tpu_torch.envs import make_env
from m3p2i_aip_tpu_torch.ops import albert_rollout as ar
from m3p2i_aip_tpu_torch.ops import cuda_build
from m3p2i_aip_tpu_torch.models import panda_env
from m3p2i_aip_tpu_torch.ops import panda_rollout as pr
from m3p2i_aip_tpu_torch.ops import panda_step as pps
from m3p2i_aip_tpu_torch.ops import point_step as ps
from m3p2i_aip_tpu_torch.ops import rollout as ro
from m3p2i_aip_tpu_torch.ops import weights


def _constants(source: str) -> dict:
    """``constexpr int`` values of a source, and ``N_SCALARS`` of its
    ``enum Scalar`` (given, or counted from the enumerators before it)."""
    text = (cuda_build.CSRC_DIR / source).read_text()
    consts = {name: int(v) for name, v in re.findall(r"constexpr int (\w+) = (\d+);", text)}
    enum = re.search(r"enum Scalar \{(.*?)\};", text, re.S)
    if enum is not None:
        names = [e.split("=")[0].strip() for e in enum.group(1).split(",") if e.strip()]
        given = re.search(r"N_SCALARS = (\d+)", enum.group(1))
        consts["N_SCALARS"] = int(given.group(1)) if given else names.index("N_SCALARS")
    return consts


def _check_point(c: dict) -> None:
    assert (c["kMaxD"], c["kMaxS"], c["N_SCALARS"]) == (ro.MAX_DYN, ro.MAX_STAT, ro._N_SCALARS)
    p = make_env(load_config("config_point"), device="cpu").params
    box = p.dyn_actor_idx.index(list(p.actor_names).index("box"))
    buf = ro._param_buffer(p, 1.0, box)
    D, S, n = p.dyn_half.shape[0], p.stat_pos.shape[0], c["N_SCALARS"]
    assert buf.size == n + c["kDynStride"] * D + c["kStatStride"] * S
    dyn = buf[n : n + c["kDynStride"] * D].reshape(D, c["kDynStride"])
    stat = buf[n + c["kDynStride"] * D :].reshape(S, c["kStatStride"])
    np.testing.assert_array_equal(dyn[:, :2], p.dyn_half.numpy())  # hx, hy lead each box row
    np.testing.assert_array_equal(stat[:, :2], p.stat_pos.numpy())  # x, y lead each static row
    np.testing.assert_array_equal(stat[:, 6], p.stat_friction.numpy())  # friction ends it


def _check_panda(c: dict) -> None:
    assert (c["kMaxS"], c["N_SCALARS"]) == (pr.MAX_STAT, pr._N_SCALARS)
    p = make_env(load_config("config_panda"), device="cpu").params
    buf = pr._param_buffer(p, 0.05)
    S, n = p.stat_min.shape[0], c["N_SCALARS"]
    nb, ns, nu = 3 * c["kBodyStride"], S * c["kStatStride"], (S + 1) * c["kSupStride"]
    assert buf.size == n + nb + ns + nu
    body = buf[n : n + nb].reshape(3, c["kBodyStride"])
    stat = buf[n + nb : n + nb + ns].reshape(S, c["kStatStride"])
    sup = buf[n + nb + ns :].reshape(S + 1, c["kSupStride"])
    np.testing.assert_array_equal(body[:, :3], p.body_half.numpy())
    np.testing.assert_array_equal(stat[:, :3], p.stat_min.numpy())
    np.testing.assert_array_equal(sup[:, 4], p.sup_z.numpy())


def _check_albert(c: dict) -> None:
    assert (c["kStateLen"], c["kNu"], c["N_SCALARS"]) == (ar.STATE_LEN, ar.N_U, ar._N_SCALARS)


def _check_weights(c: dict) -> None:
    assert c["kBetaIters"] == weights.BETA_ITERS
    # the [K] cost-to-go lies in shared memory up to kSmemMaxK samples, which
    # with the static arrays fit the 227 KB a block may opt in to; above, in
    # the wrapper's global scratch; a launch takes at most kMaxB seeds
    assert c["kSmemMaxK"] == weights.SMEM_MAX_K and 4 * c["kSmemMaxK"] + 8 * 1024 <= 227 * 1024
    assert c["kMaxB"] == weights.MAX_B == 65535
    # one warp at least per candidate beta, and the first step's split has
    # a candidate each way
    assert 2 <= c["kCandidates"] and 32 * c["kCandidates"] <= c["kMaxThreads"]
    assert 32 % c["kLanes"] == 0
    # the candidates' betas are repeated products, bit for bit the loop's:
    # no power function in the source
    code = re.sub(r"//[^\n]*", "", (cuda_build.CSRC_DIR / "multimodal_weights.cu").read_text())
    assert not re.search(r"\b(__)?(powf?|exp2f|exp10f)\s*\(", code)


def _enum(source: str, name: str) -> list:
    """The enumerators of ``enum name`` in a source, before its count."""
    body = re.search(rf"enum {name} \{{(.*?)\}};", (cuda_build.CSRC_DIR / source).read_text(), re.S).group(1)
    return [e.split("=")[0].strip() for e in body.split(",") if e.strip()][:-1]


def _check_point_step(c: dict) -> None:
    # the wrapper's limits are the point rollout kernel's (rollout.check_scene)
    assert (c["kMaxD"], c["kMaxS"], c["N_SCALARS"]) == (ro.MAX_DYN, ro.MAX_STAT, ps.N_SCALARS)
    assert (c["kDynStride"], c["kStatStride"]) == (ps.DYN_STRIDE, ps.STAT_STRIDE)
    assert (c["kRowRobot"], c["kRowDyn"], c["kRowDyn"] + c["kMaxD"]) == (ps.ROW_ROBOT, ps.ROW_DYN, ps.ROW_STAT)
    # the operands the wrapper passes, in the kernel's order
    assert [e[2:].lower() for e in _enum("point_step.cu", "Input")] == list(ps.INPUTS)
    assert [e[2:].lower() for e in _enum("point_step.cu", "Output")] == list(ps.OUTPUTS)
    # the block is one team of the point rollout kernel's width: one round
    # of boxes in passes 1 and 5, kMaxS statics in two rounds, pass 3's
    # 32-lane yaw tree over 4 corners x kTeam lanes
    assert 32 % c["kTeam"] == 0 and c["kTeam"] % c["kMaxD"] == 0 and 4 * c["kTeam"] == 32
    assert c["kMaxS"] <= 2 * c["kTeam"]


def _check_panda_step(c: dict) -> None:
    # the wrapper's limits are the panda rollout kernel's; the bodies are panda_env's
    assert (c["kMaxS"], c["kBodies"], c["N_SCALARS"]) == (pr.MAX_STAT, len(panda_env.DYN_NAMES), pps.N_SCALARS)
    assert (c["kJointStride"], c["kBodyStride"], c["kStatStride"], c["kSupStride"]) == (
        pps.JOINT_STRIDE, pps.BODY_STRIDE, pps.STAT_STRIDE, pps.SUP_STRIDE)
    assert (c["kRowRobot"], c["kRowDyn"], c["kRowDyn"] + c["kBodies"]) == (pps.ROW_ROBOT, pps.ROW_DYN, pps.ROW_STAT)
    assert [e[2:].lower() for e in _enum("panda_step.cu", "Input")] == list(pps.INPUTS)
    assert [e[2:].lower() for e in _enum("panda_step.cu", "Output")] == list(pps.OUTPUTS)
    # the block is one warp; the second round's probes and cubeA-cubeB take one lane each
    assert c["kTeam"] == 32 and c["kTeam"] >= c["kProbes"] + 1


CHECKS = {
    "point_rollout.cu": _check_point,
    "point_step.cu": _check_point_step,
    "panda_step.cu": _check_panda_step,
    "panda_rollout.cu": _check_panda,
    "albert_rollout.cu": _check_albert,
    "multimodal_weights.cu": _check_weights,
}


def test_every_source_has_a_check():
    assert sorted(CHECKS) == sorted(cuda_build.SOURCES)


@pytest.mark.parametrize("source", list(CHECKS))
def test_source_constants_match_the_wrapper(source):
    CHECKS[source](_constants(source))


# what each team kernel's lane mapping needs of its team width
TEAM_MAPPINGS = {
    # the boxes of passes 1 and 5 fit one round, a pass-2 round holds whole
    # rows; pass 3's yaw tree is the plain version's 32-lane reduction over
    # 4 corners x kTeam lanes, in at most two rounds of statics
    "point_rollout.cu": lambda c: c["kTeam"] % c["kMaxD"] == 0 and 4 * c["kTeam"] == 32
    and c["kMaxS"] <= 2 * c["kTeam"],
    # the arm probes on lanes 0 .. kProbes - 1 and cubeA-cubeB on lane kProbes, one round
    "panda_rollout.cu": lambda c: c["kTeam"] >= c["kProbes"] + 1,
    # a round scores kTeam steps' FK and cost, one a lane: with more than one
    # lane they leave the chain
    "albert_rollout.cu": lambda c: c["kTeam"] > 1,
}


@pytest.mark.parametrize("source", list(TEAM_MAPPINGS))
def test_team_fits_the_warp(source):
    """A team of kTeam lanes never straddles a warp, a block holds whole
    warps, and the kernel's lane mapping fits the team."""
    c = _constants(source)
    assert 32 % c["kTeam"] == 0
    assert c["kThreads"] % 32 == 0
    assert TEAM_MAPPINGS[source](c)


def _global_names() -> list:
    """The name of every ``__global__`` function of the sources."""
    names = []
    for path in sorted(cuda_build.CSRC_DIR.glob("*.cu")):
        names += re.findall(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(",
                            path.read_text())
    return names


def _symbols() -> list:
    from benchmark import layers
    from m3p2i_aip_tpu_torch.analysis import bench_record

    return sorted(set(layers.KERNEL_SYMBOLS) | set(bench_record.KERNEL_SYMBOLS.values()))


@pytest.mark.parametrize("symbol", _symbols())
def test_each_kernel_symbol_names_one_kernel(symbol):
    """The benchmark (``benchmark/layers.py``) and the launch counters
    (``analysis/bench_record.py``) pick a kernel's launches in a trace by a
    substring of its symbol: each must be in exactly one ``__global__`` name,
    or a roofline share reads another kernel's launches (or none)."""
    names = _global_names()
    assert len(names) == len(cuda_build.SOURCES)  # one kernel a source
    assert len([n for n in names if symbol in n]) == 1, names


def test_no_kernel_symbol_holds_another():
    """``benchmark/layers.kernel_median_s`` and ``bench_record.traced_launches``
    match a trace's kernels by ``symbol in name``: a symbol inside another's
    (``panda_rollout_kernel`` in a ``panda_rollout_kernel_step``) would give
    one kernel's roofline share the other's launches, or none."""
    symbols = _symbols()
    assert [(a, b) for a in symbols for b in symbols if a != b and a in b] == []


@pytest.mark.parametrize("source", ["point_step.cu", "panda_step.cu"])
def test_step_kernels_keep_the_plain_floating_point(source):
    """The real-env step kernels hold the plain step's bits, so they build
    with every source's flags (one flag set, no per-source flags): IEEE
    division and square root, no fast math, no FMA contraction; and their
    code calls no approximate intrinsic."""
    assert source in cuda_build.SOURCES
    flags = cuda_build.NVCC_FLAGS
    assert "-fmad=false" in flags and not any("fast" in f for f in flags)
    assert not any(f.startswith(("-prec-div", "-prec-sqrt", "-ftz")) for f in flags)
    code = re.sub(r"//[^\n]*", "", (cuda_build.CSRC_DIR / source).read_text())
    assert not re.search(r"\b__(sinf|cosf|tanf|expf|exp10f|logf|log2f|powf|fdividef|frcp_r[nduz]|fsqrt_r[nduz]|"
                         r"fdiv_r[nduz])\s*\(", code)
