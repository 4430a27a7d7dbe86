"""Experiment logging and offline statistics (parity: the reference's plot/)."""
from m3p2i_aip_tpu_torch.analysis.run_logger import (
    RunLogger,
    finalize_albert_row,
    finalize_panda_row,
    finalize_point_row,
)
from m3p2i_aip_tpu_torch.analysis.stats import mean_std, panda_costs, per_seed, point_costs, summarize
