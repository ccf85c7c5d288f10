"""The port's torch-checkpoint conversion (``runtime/convert.py``) against
``bioengine_tpu/runtime/convert.py``: the same name maps, the same
transforms and the same npz, and the converted ViT-L cpsam layout against
the port's full-width ``CpSAM``.

Tolerance: none. Conversion is a relayout of the checkpoint's bytes, so
every array is held bit for bit, and ``convert_checkpoint``'s npz member
by member (name, order and bytes).
"""

import json
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch

from bioengine_tpu.runtime import convert as jax_convert
from _torch_parity import few_torch_threads  # noqa: F401
from bioengine_tpu_torch.models.sam import CpSAM
from bioengine_tpu_torch.models.vit import ViT
from bioengine_tpu_torch.runtime import convert

FIXTURES = Path(__file__).resolve().parent
TINY = dict(
    patch_size=8, dim=32, depth=2, num_heads=2, window_size=2,
    global_attn_indexes=(1,), neck_dim=16, pretrain_grid=4,
)
MANIFESTS = {
    "cpsam_vitl": ("fixtures_manifest_cpsam_vitl.json", "cpsam_name_map", 24),
    "dinov2_vitb14": ("fixtures_manifest_dinov2_vitb14.json", "dinov2_name_map", 12),
}


def _manifest(case):
    fname, map_name, depth = MANIFESTS[case]
    manifest = json.loads((FIXTURES / fname).read_text())
    return manifest, getattr(convert, map_name)(depth), getattr(jax_convert, map_name)(depth), depth


def _assert_trees_equal(a, b):
    fa, fb = convert.flatten_params(a), jax_convert.flatten_params(b)
    assert list(fa) == list(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and fa[k].shape == fb[k].shape, k
        np.testing.assert_array_equal(fa[k], fb[k])


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("cfg", [TINY, {**TINY, "depth": 3, "global_attn_indexes": (0, 2)}],
                         ids=["tiny", "depth3"])
def test_synthetic_cpsam_conversion_bit_equal_to_jax(cfg, seed):
    sd = convert.synthetic_cpsam_state_dict(**cfg, seed=seed)
    ref_sd = jax_convert.synthetic_cpsam_state_dict(**cfg, seed=seed)
    assert list(sd) == list(ref_sd)
    for k in sd:
        np.testing.assert_array_equal(sd[k], ref_sd[k])
    depth = cfg["depth"]
    assert convert.infer_depth(sd) == jax_convert.infer_depth(ref_sd) == depth
    _assert_trees_equal(
        convert.convert_state_dict(sd, convert.cpsam_name_map(depth)),
        jax_convert.convert_state_dict(ref_sd, jax_convert.cpsam_name_map(depth)),
    )


def test_strict_mode_names_unmapped_keys():
    sd = convert.synthetic_cpsam_state_dict(**TINY)
    sd["encoder.blocks.0.attn.new_thing"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="new_thing"):
        convert.convert_state_dict(sd, convert.cpsam_name_map(depth=2), strict=True)
    loose = convert.convert_state_dict(sd, convert.cpsam_name_map(depth=2), strict=False)
    assert "new_thing" not in str(convert.flatten_params(loose).keys())


def test_known_drops_and_unknown_arch():
    sd = {"mask_token": np.zeros((1, 8), np.float32), "cls_token": np.ones((1, 1, 8), np.float32)}
    params = convert.convert_state_dict(sd, convert.dinov2_name_map(depth=0))
    assert set(params) == {"cls_token"}
    with pytest.raises(ValueError, match="unknown arch"):
        convert.convert_checkpoint("resnet", "missing.pth", "out.npz")
    with pytest.raises(ValueError, match="blocks"):
        convert.infer_depth({"pos_embed": np.zeros(1)})


@pytest.mark.parametrize("case", sorted(MANIFESTS))
def test_name_maps_cover_the_manifests_exactly(case):
    manifest, name_map, ref_map, _ = _manifest(case)
    assert set(name_map) == set(manifest) == set(ref_map)
    for key, rule in name_map.items():
        ref = ref_map[key]
        assert (rule is None) == (ref is None), key
        if rule is not None:
            assert rule[0] == ref[0], key


def _zero_strided(shape):
    """A read-only array of ``shape`` over one float: the transforms are
    views, so a manifest's shapes go through without allocating it."""
    return np.lib.stride_tricks.as_strided(np.zeros(1, np.float32), shape, (0,) * len(shape))


@pytest.mark.parametrize("case", sorted(MANIFESTS))
def test_manifest_converts_to_the_port_models_state_dict(case):
    """The published layouts, converted key by key and carried over by the
    bridge, give exactly the names and shapes of the port's full-width
    model (built on the meta device: nothing of its ~1.2 GB is allocated)."""
    manifest, name_map, _, depth = _manifest(case)
    assert convert.infer_depth(manifest) == depth
    with torch.device("meta"):
        model = CpSAM() if case == "cpsam_vitl" else ViT(img_size=518)
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    got = {}
    for tkey, shape in manifest.items():
        rule = name_map[tkey]
        if rule is None:
            continue
        fpath, transform = rule
        flax_shape = transform(_zero_strided(tuple(shape))).shape
        # one tensor at a time through the bridge, at its converted shape
        (key, tensor), = convert.state_dict_from_flax(
            {fpath: np.zeros(flax_shape, np.float32)}
        ).items()
        got[key] = tuple(tensor.shape)
    assert got == want
    if case == "cpsam_vitl":
        n = sum(int(np.prod(s)) for s in want.values())
        assert 300e6 < n < 310e6  # ViT-L's ~303 M


def test_convert_checkpoint_writes_the_jax_converters_npz(tmp_path):
    sd = convert.synthetic_cpsam_state_dict(**TINY, seed=3)
    pth = tmp_path / "cpsam.pth"
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}}, pth)
    port_npz, jax_npz = tmp_path / "port.npz", tmp_path / "jax.npz"
    params = convert.convert_checkpoint("cpsam", str(pth), str(port_npz))
    ref = jax_convert.convert_checkpoint("cpsam", str(pth), str(jax_npz))
    _assert_trees_equal(params, ref)
    # member by member: the same names in the same order, the same bytes
    # (the zip's timestamps aside)
    with zipfile.ZipFile(port_npz) as a, zipfile.ZipFile(jax_npz) as b:
        assert a.namelist() == b.namelist()
        for name in a.namelist():
            assert a.read(name) == b.read(name), name
    _assert_trees_equal(convert.load_params_npz(str(port_npz)), jax_convert.load_params_npz(str(jax_npz)))
    # and it loads into the port's model through the bridge
    model = CpSAM(**TINY)
    model.load_state_dict(convert.state_dict_from_flax(convert.load_params_npz(str(port_npz))))
    torch.testing.assert_close(model.out.weight, torch.from_numpy(sd["out.weight"]), rtol=0, atol=0)
    torch.testing.assert_close(
        model.encoder.block0.attn.qkv.weight,
        torch.from_numpy(sd["encoder.blocks.0.attn.qkv.weight"]), rtol=0, atol=0,
    )
