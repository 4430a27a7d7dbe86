"""Procedurally emitted URDFs (port of ``m3p2i_aip_tpu/assets``): the
emitters of ``urdf_gen``, built on the port's kinematic constants."""
from m3p2i_aip_tpu_torch.assets.urdf_gen import (  # noqa: F401
    emit_albert_urdf,
    emit_boxer_urdf,
    emit_franka_urdf,
    emit_heijn_urdf,
    emit_husky_urdf,
    emit_point_urdf,
    ensure_assets,
)
