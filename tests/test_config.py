"""Config system tests: .cfg parsing and PBAConfig."""

import pytest

from photobundle_tpu.config import ConfigFile, PBAConfig

CFG_TEXT = """
# KITTI stereo example (reference config format)
dataDir = /data/kitti
sequence = 0
descriptor = IntensityAndGradient
slidingWindowSize = 7
patchRadius = 3
maxNumPoints = 8192
minScore = 0.8       # zncc gate
robustThreshold = 0.07
numFrames = 200
solverVerbose = true
unknownKeyIgnored = whatever
"""


def test_configfile_parse():
    cfg = ConfigFile(text=CFG_TEXT)
    assert cfg.get("dataDir") == "/data/kitti"
    assert cfg.get("sequence", 0) == 0
    assert cfg.get("slidingWindowSize", 5) == 7
    assert cfg.get("minScore", 0.75) == 0.8
    assert cfg.get("solverVerbose", False) is True
    assert cfg.get("missing", 42) == 42
    with pytest.raises(KeyError):
        cfg.get("missing")


def test_pbaconfig_from_cfg(tmp_path):
    p = tmp_path / "test.cfg"
    p.write_text(CFG_TEXT)
    c = PBAConfig.from_config_file(str(p))
    assert c.descriptor == "IntensityAndGradient"
    assert c.slidingWindowSize == 7
    assert c.patchRadius == 3
    assert c.patch_size == 7
    assert c.num_channels == 3
    assert c.patch_dim == 7 * 7 * 3
    assert c.maxNumPoints == 8192
    assert c.robustThreshold == 0.07
    # defaults for unspecified keys
    assert c.maxIterations == 50


def test_pbaconfig_validation():
    with pytest.raises(ValueError):
        PBAConfig(descriptor="Nope").validate()
    with pytest.raises(ValueError):
        PBAConfig(slidingWindowSize=1).validate()
    with pytest.raises(ValueError):
        PBAConfig(gradientMode="bogus").validate()
    with pytest.raises(ValueError):
        PBAConfig(robustLoss="bogus").validate()
    for kind in ("huber", "cauchy", "tukey", "none"):
        PBAConfig(robustLoss=kind).validate()
    with pytest.raises(ValueError):
        PBAConfig(patchNormalization="bogus").validate()
    # resolve_normalization: the legacy bool forces 'off'.
    assert PBAConfig().resolve_normalization() == "mean"
    assert PBAConfig(patchNormalization="affine").resolve_normalization() == "affine"
    assert PBAConfig(normalizePatches=False).resolve_normalization() == "off"
    assert (PBAConfig(normalizePatches=False, patchNormalization="affine")
            .resolve_normalization() == "off")
    # The fused Triton sampler implements fixed-grid bilinear 'sampled'
    # gradients under 'mean'/'off' normalization; forcing it onto any other
    # mode must fail at config load.
    PBAConfig(solverBackend="triton").validate()
    PBAConfig(solverBackend="triton", patchNormalization="off").validate()
    for bad in (dict(patchWarp="scale"), dict(patchWarp="affine"),
                dict(interpolation="bicubic"), dict(gradientMode="exact"),
                dict(patchNormalization="affine"), dict(patchScale=True)):
        with pytest.raises(ValueError):
            PBAConfig(solverBackend="triton", **bad).validate()
    with pytest.raises(ValueError):
        PBAConfig(solverBackend="pallas").validate()
    with pytest.raises(ValueError):
        PBAConfig(patchWarp="bogus").validate()
    for mode in ("scale", "affine"):
        PBAConfig(patchWarp=mode).validate()
        assert PBAConfig(patchWarp=mode).resolve_patch_warp() == mode
    assert PBAConfig(patchWarp="affine").resolve_backend() == "xla"
    # patchScale is the deprecated spelling of patchWarp='scale'.
    PBAConfig(patchScale=True).validate()
    assert PBAConfig(patchScale=True).resolve_patch_warp() == "scale"
    assert PBAConfig().resolve_patch_warp() is None


def test_pbaconfig_hashable_and_replace():
    c = PBAConfig()
    assert hash(c) == hash(PBAConfig())
    c2 = c.replace(patchRadius=3)
    assert c2.patch_size == 7 and c.patch_size == 5
