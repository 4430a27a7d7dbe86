"""m3p2i_aip_tpu_torch — the PyTorch/CUDA port of ``m3p2i_aip_tpu``.

The same multi-modal MPPI + reactive TAMP system, written on ``torch`` for
one NVIDIA H100 (``sm_90a``).  The layout mirrors the JAX package:

  * ``config``   — the structured configs and the hydra-style override grammar
                   (YAMLs are read from ``m3p2i_aip_tpu/config`` by path)
  * ``sim``      — planar PBD contact primitives, batched over leading dims
  * ``models``   — the point-robot scene (point / heijn / boxer bases)
  * ``ops``      — control ops, Halton-spline sampling, filters, and the two
                   hand-written CUDA kernels (``ops/rollout.py``,
                   ``ops/weights.py``; sources under ``csrc/``)
  * ``planners`` — the halton-spline M3P2I planner, the point costs, and the
                   host-side task planners
  * ``tamp``     — ``ReactiveTAMP`` and the chunked ``SimLoop``
  * ``parallel`` — the sample axis (and a seed batch) split over a list of
                   devices, one kernel launch per shard
  * ``utils``    — suction model, paths, and the JAX-to-torch state converters

The package imports ``torch`` and numpy and never ``jax``.  Every tensor
carries an explicit device; a kernel wrapper launches its CUDA kernel for a
CUDA tensor and runs its plain PyTorch version for a CPU tensor.
"""

__version__ = "0.1.0"
