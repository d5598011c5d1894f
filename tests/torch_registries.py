"""Both packages keep their option registries as module globals
(`wass_tpu/config.py`, `wass_tpu_torch/config.py`), and loading a config
file sets values there that nothing resets.  A test module of the port
that loads a config, through either package, imports this autouse
fixture: after each of its tests both registries go back to their
defaults, so that no loaded value reaches a later test of the same
worker (loads made by module-scoped fixtures included)."""

import pytest

from wass_tpu import config as jconfig
from wass_tpu_torch import config as tconfig


@pytest.fixture(autouse=True)
def reset_registries():
    yield
    jconfig.reset_all()
    tconfig.reset_all()
