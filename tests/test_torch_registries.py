"""No test leaves an option registry changed: a MAX_DISPARITY=96 config
loaded through the JAX package's `_load_pipeline` and through the port's
CLI within the reset fixture (tests/torch_registries.py) is gone from both
registries by the next test.  The two tests run in file order (pytest
keeps it within a module)."""

from wass_tpu import config as jconfig
from wass_tpu.cli.main import _load_pipeline
from wass_tpu_torch import config as tconfig
from wass_tpu_torch.cli.main import main as torch_main
from torch_registries import reset_registries  # noqa: F401  (autouse)


def test_config_loads_set_both_registries(tmp_path):
    """An empty sequence directory with a stereo_config.txt: both packages
    load it (the port's stereo command reconstructs no frame)."""
    (tmp_path / "stereo_config.txt").write_text("MAX_DISPARITY=96\n")
    _load_pipeline(tmp_path)
    assert torch_main(["stereo", str(tmp_path), "--device", "cpu"]) == 0
    assert jconfig.registry("stereo").get("MAX_DISPARITY") == 96
    assert tconfig.registry("stereo").get("MAX_DISPARITY") == 96


def test_registries_back_to_defaults():
    """After the loading test the fixture has reset both registries."""
    assert jconfig.registry("stereo").get("MAX_DISPARITY") == 640
    assert tconfig.registry("stereo").get("MAX_DISPARITY") == 640
