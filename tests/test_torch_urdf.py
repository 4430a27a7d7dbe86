"""The port's URDF loader (``utils/urdf.py``) against the JAX package's and
against the port's native FK, on the CPU: tests/test_urdf.py's checks
(:31, :73, :79) on the port, and in place of its external-URDF check (:102)
the albert's base-composed FK against the vendored albert URDF.

The vendored URDFs are read in place from ``m3p2i_aip_tpu/assets/urdf/``
through ``path_utils.get_assets_path()``.  Bar: 1e-5, tests/test_urdf.py's
(float32 FK through seven joints in another association order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m3p2i_aip_tpu.utils import urdf as jurdf
from m3p2i_aip_tpu_torch.models import albert, panda_fk
from m3p2i_aip_tpu_torch.utils import urdf
from m3p2i_aip_tpu_torch.utils.path_utils import get_assets_path

ATOL = 1e-5
_SYNTH = """
<robot name="rr">
  <joint name="j1" type="revolute">
    <parent link="base"/><child link="l1"/>
    <origin xyz="0 0 1" rpy="0 0 0"/><axis xyz="0 0 1"/>
    <limit lower="-3" upper="3" effort="10" velocity="1"/>
  </joint>
  <joint name="j2" type="prismatic">
    <parent link="l1"/><child link="l2"/>
    <origin xyz="1 0 0" rpy="0 0 0"/><axis xyz="1 0 0"/>
    <limit lower="0" upper="0.5" effort="10" velocity="1"/>
  </joint>
  <joint name="jt" type="fixed">
    <parent link="l2"/><child link="tool"/>
    <origin xyz="0.1 0 0" rpy="0 0 0"/>
  </joint>
</robot>
"""
VENDORED = ("pointRobot.urdf", "heijn.urdf", "boxer/boxer.urdf", "albert/albert.urdf",
            "franka_description/robots/franka_panda.urdf", "husky_description/husky.urdf")


def _urdf(rel: str) -> str:
    return str(get_assets_path() / "urdf" / rel)


def _q7(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.uniform(panda_fk.JOINT_LOWER[:7], panda_fk.JOINT_UPPER[:7], size=(n, 7)).astype(np.float32)


def test_synthetic_chain_fk():
    """tests/test_urdf.py:31 on the port, and the same poses as the JAX chain."""
    joints = urdf.parse_urdf(_SYNTH)
    assert set(joints) == {"j1", "j2", "jt"}
    chain = urdf.chain_to(joints, "tool")
    assert chain.ndof == 2
    lo, hi = chain.joint_limits
    assert lo[0] == -3 and hi[1] == 0.5
    q = np.array([np.pi / 2, 0.3], np.float32)
    pos, rot = chain.fk(torch.as_tensor(q))["tool"]
    assert np.allclose(pos.numpy(), [0.0, 1.4, 1.0], atol=ATOL)  # the x-offset link swings to +y
    jpos, jrot = jurdf.chain_to(jurdf.parse_urdf(_SYNTH), "tool").fk(jnp.asarray(q))["tool"]
    np.testing.assert_allclose(pos.numpy(), np.asarray(jpos), atol=ATOL, rtol=0)
    np.testing.assert_allclose(rot.numpy(), np.asarray(jrot), atol=ATOL, rtol=0)


def test_native_panda_fk_matches_vendored_urdf():
    """tests/test_urdf.py:73: the vendored franka URDF through the port's
    loader, batched over five random joint vectors, against the port's
    matrix FK (hand pose) and the JAX loader's FK."""
    chain = urdf.load_chain(_urdf("franka_description/robots/franka_panda.urdf"), "panda_hand")
    q7 = _q7(5)
    q9 = torch.as_tensor(np.concatenate([q7, np.full((5, 2), 0.02, np.float32)], axis=1))
    n_pos, n_rot = panda_fk.fk(q9, torch.zeros(3))["hand"]
    u_pos, u_rot = chain.fk(torch.as_tensor(q7))["panda_hand"]
    assert u_pos.shape == (5, 3) and u_rot.shape == (5, 3, 3)
    np.testing.assert_allclose(u_pos.numpy(), n_pos.numpy(), atol=ATOL, rtol=0)
    np.testing.assert_allclose(u_rot.numpy(), n_rot.numpy(), atol=ATOL, rtol=0)
    jchain = jurdf.load_chain(_urdf("franka_description/robots/franka_panda.urdf"), "panda_hand")
    for b in range(5):
        j_pos, j_rot = jchain.fk(jnp.asarray(q7[b]))["panda_hand"]
        np.testing.assert_allclose(u_pos[b].numpy(), np.asarray(j_pos), atol=ATOL, rtol=0)
        np.testing.assert_allclose(u_rot[b].numpy(), np.asarray(j_rot), atol=ATOL, rtol=0)


def test_vendored_urdfs_parse():
    """tests/test_urdf.py:79: the chains and the joint counts of the six
    vendored URDFs, read in place."""
    assert urdf.chain_to(urdf.parse_urdf(_urdf("albert/albert.urdf")), "panda_hand").ndof == 7
    assert urdf.chain_to(urdf.parse_urdf(_urdf("pointRobot.urdf")), "base_link").ndof == 2
    assert urdf.chain_to(urdf.parse_urdf(_urdf("heijn.urdf")), "base_link").ndof == 3
    assert sum(j.type != "fixed" for j in urdf.parse_urdf(_urdf("boxer/boxer.urdf")).values()) == 4
    assert sum(j.type != "fixed" for j in urdf.parse_urdf(_urdf("husky_description/husky.urdf")).values()) == 4


@pytest.mark.parametrize("rel", VENDORED)
def test_parsed_joints_equal_jax_package(rel):
    """Every joint field of every vendored URDF as the JAX loader reads it."""
    mine, ref = urdf.parse_urdf(_urdf(rel)), jurdf.parse_urdf(_urdf(rel))
    assert list(mine) == list(ref)
    for name in ref:
        a, b = mine[name], ref[name]
        assert (a.type, a.parent, a.child, a.lower, a.upper, a.effort, a.velocity) == (
            b.type, b.parent, b.child, b.lower, b.upper, b.effort, b.velocity
        ), name
        for f in ("xyz", "rpy", "axis"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), (name, f)


def test_albert_composed_fk_matches_vendored_urdf():
    """The albert's FK (the panda chain at the base pose with the arm mount
    composed in, ``models/albert.fk``) against the vendored albert URDF's
    base_link -> panda_hand chain placed at the same base pose."""
    chain = urdf.load_chain(_urdf("albert/albert.urdf"), "panda_hand", root_link="base_link")
    rng = np.random.default_rng(1)
    q7 = _q7(4, seed=1)
    base = np.stack([rng.uniform(-2, 2, 4), rng.uniform(-2, 2, 4), rng.uniform(-np.pi, np.pi, 4)], axis=1).astype(np.float32)
    q = torch.as_tensor(np.concatenate([base, q7, np.full((4, 2), 0.02, np.float32)], axis=1))
    state = albert.AlbertState(q=q, qd=torch.zeros_like(q), box_pos=torch.zeros(4, 2), box_yaw=torch.zeros(4),
                               box_vel=torch.zeros(4, 2), box_om=torch.zeros(4))
    n_pos, n_rot = albert.fk(state)["hand"]
    base_pos = torch.cat([q[:, :2], torch.zeros(4, 1)], dim=1)
    u_pos, u_rot = chain.fk(q[:, 3:10], base_pos=base_pos, base_rot=panda_fk._rot_z(q[:, 2]))["panda_hand"]
    np.testing.assert_allclose(u_pos.numpy(), n_pos.numpy(), atol=ATOL, rtol=0)
    np.testing.assert_allclose(u_rot.numpy(), n_rot.numpy(), atol=ATOL, rtol=0)
