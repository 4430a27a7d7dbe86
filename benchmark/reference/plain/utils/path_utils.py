"""Package/asset/config path helpers. Parity: utils/path_utils.py:4-26.

The port ships no YAML or URDF of its own: scene, planner and asset files are
read by path from the JAX package's tree (``m3p2i_aip_tpu/config``,
``m3p2i_aip_tpu/assets``), which sits beside this package in the repository.
Nothing here imports the JAX package.
"""
from __future__ import annotations

import pathlib

import yaml


def get_package_path() -> pathlib.Path:
    return pathlib.Path(__file__).resolve().parents[1]


def get_reference_package_path() -> pathlib.Path:
    """The JAX package's directory at the repository's root (its data
    files, read by path; none of its modules)."""
    return pathlib.Path(__file__).resolve().parents[4] / "m3p2i_aip_tpu"


def get_assets_path() -> pathlib.Path:
    return get_reference_package_path() / "assets"


def get_config_path() -> pathlib.Path:
    return get_reference_package_path() / "config"


def get_plot_path() -> pathlib.Path:
    """The repository's ``plot/`` directory: the committed run logs the plot
    scripts read (path_utils.py:23)."""
    return get_package_path().parent / "plot"


def load_yaml(file_path):
    with open(file_path) as f:
        return yaml.safe_load(f)
