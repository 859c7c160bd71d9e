"""PyTorch port: the upstream `.pth` import (`xlstm_hved_torch/utils/
torch_import.py`) against the JAX package's `utils/torch_import.py`.

No upstream checkpoint or code is in the repo, so each case builds one:
the port's weights drawn from numpy (tests/_torch_port.py, over
`jax.eval_shape` of the JAX model's init), then renamed to the upstream keys
by the test-only inverse `tests/_torch_upstream_names.py`. On that dict:

1. JAX's `*_params_from_torch` accepts it and returns the init tree itself:
   the same paths and shapes (and, the rename being lossless, the drawn
   values). JAX's importer is the independent judge of the upstream names;
2. `params_from_jax` of JAX's tree equals the port's importer on the same
   dict, bit for bit, key for key;
3. both equal the port model's original state dict, which loads strictly.

Cases: the HVED presets and config arms (the flagship, ext-resnet, the ViL
decoder, DuSFE, per-modality recon streams, single-stream deep levels), the
fusion arm, U-HeMIS, the UxLSTM nets (Enc / Bot, 2-D / 3-D, with and without
deep supervision) and the Discriminator. Also: `load_reference_checkpoint`
on both file forms; the upstream keys JAX does not read are ignored; a read
key that is missing raises KeyError naming it; the configs JAX refuses raise
NotImplementedError in both.
"""
import functools
from typing import Callable, NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port as tp
import _torch_upstream_names as up
from xlstm_hved_tpu.config import get_config as jax_config
from xlstm_hved_tpu.models import find_model_using_name as jax_model
from xlstm_hved_tpu.models import hemis as jh
from xlstm_hved_tpu.models import hved as jhved
from xlstm_hved_tpu.models import uxlstm as ju
from xlstm_hved_tpu.utils import torch_import as jti
from xlstm_hved_torch.config import get_config
from xlstm_hved_torch.models import Discriminator, find_model_using_name
from xlstm_hved_torch.models import hemis as th
from xlstm_hved_torch.models import uxlstm as tu
from xlstm_hved_torch.utils import torch_import as tti
from xlstm_hved_torch.utils.convert import params_from_jax

S = 32   # the smallest volume the upstream model itself runs


class Case(NamedTuple):
    variables: dict                 # the numpy-drawn JAX variables
    port: torch.nn.Module           # the port model holding them
    upstream: Callable              # port state dict -> upstream names
    jax_import: Callable            # upstream -> (params, batch_stats)
    port_import: Callable           # upstream -> port state dict


HVED = {
    "XLSTM_HVED": ("XLSTM_HVED", {}),
    "XLSTM_HVED-fusion_level3": ("XLSTM_HVED", {"fusion_level": 3}),
    "XLSTM_HVED-per_modality_recon": ("XLSTM_HVED", {"shared_recon": False}),
    "U_HVEDNet3D": ("U_HVEDNet3D", {}),
    "U_HVEDNet3D-fusion_level3": ("U_HVEDNet3D", {"fusion_level": 3}),
    "U_HVEDNet3D-per_modality_recon": ("U_HVEDNet3D", {"shared_recon": False}),
    "U_HVEDConvNet3D": ("U_HVEDConvNet3D", {}),
    "U_HVEDConvXLSTMNet3D": ("U_HVEDConvXLSTMNet3D", {}),
    "U_HVEDConvDuSFENet3D": ("U_HVEDConvDuSFENet3D", {}),
}
FUSION = {"FusionUNet3D": {}, "FusionUNet3D-per_modality_recon": {"shared_recon": False}}
HEMIS = {"U_HeMIS-n4": 4, "U_HeMIS-n8": 8}
STRIDES_3D = ((1, 1, 1), (2, 2, 2), (2, 2, 2), (2, 2, 2))
UXLSTM = {  # class, input size, channels, features, strides, deep supervision
    "UXlstmEnc-3d": ("UXlstmEnc", (16, 16, 16), 2, (4, 8, 16, 32), STRIDES_3D, False),
    "UXlstmEnc-3d-ds": ("UXlstmEnc", (16, 16, 16), 2, (4, 8, 16, 32), STRIDES_3D, True),
    "UXlstmBot-3d-ds": ("UXlstmBot", (16, 16, 16), 2, (4, 8, 16, 32), STRIDES_3D, True),
    "UXlstmBot-3d": ("UXlstmBot", (16, 16, 16), 2, (4, 8, 16), STRIDES_3D[:3], False),
    "UXlstmEnc-2d-ds": ("UXlstmEnc", (16, 16), 1, (4, 8, 16, 32), (1, 2, 2, 2), True),
    "UXlstmEnc-2d": ("UXlstmEnc", (16, 16), 1, (4, 8, 16), (1, 2, 2), False),
    "UXlstmBot-2d-ds": ("UXlstmBot", (16, 16), 1, (4, 8, 16), (1, 2, 2), True),
}
DISC = {"Discriminator-k4": (8, 4, 4), "Discriminator-k3": (4, 3, 3)}
CASES = sorted(HVED) + sorted(FUSION) + sorted(HEMIS) + sorted(UXLSTM) + sorted(DISC)


@functools.lru_cache(maxsize=None)
def _case(name: str) -> Case:
    if name in HVED or name in FUSION:
        preset, overrides = HVED[name] if name in HVED else ("FusionUNet3D", FUSION[name])
        jm = jax_model(preset, compute_dtype="float32", use_pallas_mlstm=False, **overrides)
        variables = tp.random_variables(jm, jnp.zeros((1, S, S, S, 4)), seed=len(name),
                                        deterministic=True, recon=True)
        port = tp.load_port(find_model_using_name(preset, device="cpu", **overrides), variables)
        jcfg, cfg = jax_config(preset, **overrides), get_config(preset, **overrides)
        if name in FUSION:
            return Case(variables, port, lambda s: up.fusion_upstream(s, cfg),
                        lambda sd: (jti.fusion_params_from_torch(sd, jcfg), None),
                        lambda sd: tti.fusion_params_from_torch(sd, cfg))
        return Case(variables, port, lambda s: up.hved_upstream(s, cfg),
                    lambda sd: jti.hved_params_from_torch(sd, jcfg),
                    lambda sd: tti.hved_params_from_torch(sd, cfg))
    if name in HEMIS:
        n = HEMIS[name]
        jm = jh.UHeMIS(num_cls=3, n_base=n)
        variables = tp.random_variables(jm, jnp.zeros((1, 16, 16, 16, 4)), seed=n)
        return Case(variables, tp.load_port(th.UHeMIS(num_cls=3, n_base=n), variables),
                    up.hemis_upstream, lambda sd: (jti.hemis_params_from_torch(sd), None),
                    tti.hemis_params_from_torch)
    if name in UXLSTM:
        cls, size, cin, feats, strides, ds = UXLSTM[name]
        kw = dict(strides=strides, n_conv_per_stage=2, n_conv_per_stage_decoder=2,
                  deep_supervision=ds)
        jm = getattr(ju, cls)(size, cin, feats, 3, **kw)
        variables = tp.random_variables(jm, jnp.zeros((1, *size, cin)), seed=len(name))
        port = tp.load_port(getattr(tu, cls)(size, cin, feats, 3, **kw), variables)
        return Case(variables, port, up.uxlstm_upstream,
                    lambda sd: (jti.uxlstm_params_from_torch(sd, jm), None),
                    lambda sd: tti.uxlstm_params_from_torch(sd, port))
    f_maps, kernel, levels = DISC[name]
    jm = jhved.Discriminator(f_maps=f_maps, kernel=kernel, num_levels=levels,
                             dtype=jnp.float32)
    variables = tp.random_variables(jm, jnp.zeros((1, S, S, S, 7)), seed=kernel)
    port = tp.load_port(Discriminator(7, f_maps, kernel, levels), variables)
    return Case(variables, port, up.disc_upstream,
                lambda sd: (jti.disc_params_from_torch(sd, levels), None),
                lambda sd: tti.disc_params_from_torch(sd, levels))


def _flat(tree, prefix=()):
    out = {}
    for key, value in (tree or {}).items():
        if isinstance(value, dict) or hasattr(value, "items"):
            out.update(_flat(value, prefix + (key,)))
        else:
            out[prefix + (key,)] = np.asarray(value)
    return out


def _assert_same_tree(got, want):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want), sorted(set(got) ^ set(want))
    for path, w in want.items():
        assert got[path].shape == w.shape, (path, got[path].shape, w.shape)
        assert np.array_equal(got[path], w), path


def _assert_same_state(got, want):
    assert sorted(got) == sorted(want), sorted(set(got) ^ set(want))
    for key, w in want.items():
        assert got[key].dtype == w.dtype and torch.equal(got[key], w), key


@pytest.mark.parametrize("name", CASES)
def test_import_agrees_with_jax_and_restores_the_port(name):
    case = _case(name)
    original = case.port.state_dict()
    upstream = case.upstream(original)
    params, stats = case.jax_import(upstream)
    _assert_same_tree(params, case.variables["params"])
    _assert_same_tree(stats, case.variables.get("batch_stats"))
    got = case.port_import(upstream)
    _assert_same_state(got, params_from_jax(params, stats))
    _assert_same_state(got, original)
    case.port.load_state_dict(got, strict=True)


@pytest.mark.parametrize("form", ["model_sd", "bare"])
def test_load_reference_checkpoint_reads_both_file_forms(form, tmp_path):
    case = _case("XLSTM_HVED")
    upstream = case.upstream(case.port.state_dict())
    path = tmp_path / "upstream.pth"
    torch.save({"model_sd": upstream, "epoch": 3} if form == "model_sd" else upstream, path)
    got = tti.load_reference_checkpoint(str(path), get_config("XLSTM_HVED"))
    params, stats = jti.load_reference_checkpoint(str(path), jax_config("XLSTM_HVED"))
    _assert_same_state(got, params_from_jax(params, stats))
    _assert_same_state(got, case.port.state_dict())


# upstream weights that no forward reaches; neither importer reads them
DEAD = {
    "XLSTM_HVED-fusion_level3": (
        "mViL.norm.weight", "mViL.norm.bias",                          # the ViL wrapper's norm
        "srdecoder.dusfe_decoders.0.conv_fuse_ch1.weight",             # DuSE's adjuncts
        "srdecoder.dusfe_decoders.1.conv_fuse_ch2.bias",
        "skr_att.1.0.identity_mapping.conv.weight",                    # the gates' dead map
        "skr_att.0.0.conv1.dwconv.weight",                             # the deepest gate
        "DRBs.3.0.0.conv.weight", "VU_blocks.3.0.conv.weight",         # the deep level's
        "conv_blocks.3.conv.weight"),                                  # MVAE twins
    "UXlstmEnc-3d": ("decoder.seg_layers.0.weight", "decoder.seg_layers.1.bias",
                     "encoder.stem.1.conv1.all_modules.0.weight"),
}


@pytest.mark.parametrize("name", sorted(DEAD))
def test_keys_jax_does_not_read_are_ignored(name):
    case = _case(name)
    upstream = case.upstream(case.port.state_dict())
    rng = np.random.RandomState(5)
    for key in DEAD[name]:
        assert key not in upstream, key
        upstream[key] = torch.from_numpy(rng.randn(3, 2).astype(np.float32))
    tracked = [k for k in upstream if k.endswith("num_batches_tracked")]
    for key in tracked:
        upstream[key] = torch.tensor(7)
    params, stats = case.jax_import(upstream)
    got = case.port_import(upstream)
    _assert_same_state(got, params_from_jax(params, stats))
    _assert_same_state(got, case.port.state_dict())
    assert all(int(got[k]) == 0 for k in got if k.endswith("num_batches_tracked"))
    assert tracked or name.startswith("UXlstm")


MISSING = {
    "XLSTM_HVED": "mViL.vil.layer.proj_up.weight",
    "U_HVEDNet3D": "init_blocks.2.0.bias",
    "FusionUNet3D": "FBs.1.gate.mlp.3.bias",
    "U_HeMIS-n4": "enc_list.3.encoder.5.SingleConv2.conv.bias",
    "UXlstmEnc-3d-ds": "decoder.seg_layers.0.weight",
    "UXlstmBot-2d-ds": "xlstm.vil.layer.mlstm_cell.fgate.bias",
    "Discriminator-k4": "last.weight",
}


@pytest.mark.parametrize("name", sorted(MISSING))
def test_a_missing_read_key_raises_key_error_naming_it(name):
    case = _case(name)
    upstream = case.upstream(case.port.state_dict())
    key = MISSING[name]
    del upstream[key]
    for importer in (case.jax_import, case.port_import):
        with pytest.raises(KeyError, match=key.replace(".", r"\.")):
            importer(upstream)


@pytest.mark.parametrize("preset,overrides", [
    ("FusionUNet3D", {}),                      # the non-MVAE fusion arm
    ("XLSTM_HVED", {"mvae_reduction": False}),
    ("U_HVEDConvNet3D", {"mvae": False}),      # the plain multi-stream arm
])
def test_configs_jax_refuses_raise_not_implemented(preset, overrides):
    upstream = _case("XLSTM_HVED").upstream(_case("XLSTM_HVED").port.state_dict())
    with pytest.raises(NotImplementedError):
        jti.hved_params_from_torch(upstream, jax_config(preset, **overrides))
    with pytest.raises(NotImplementedError):
        tti.hved_params_from_torch(upstream, get_config(preset, **overrides))


def test_uxlstm_import_refuses_checkpoints_without_conv_bias():
    case = _case("UXlstmEnc-3d")
    upstream = case.upstream(case.port.state_dict())
    del upstream["encoder.stem.0.conv1.bias"]
    with pytest.raises(NotImplementedError, match="conv_bias"):
        case.jax_import(upstream)
    with pytest.raises(NotImplementedError, match="conv_bias"):
        case.port_import(upstream)


def test_fusion_import_takes_only_the_fusion_arm():
    case = _case("XLSTM_HVED")
    with pytest.raises(ValueError, match="fusion arm"):
        tti.fusion_params_from_torch(case.upstream(case.port.state_dict()),
                                     get_config("XLSTM_HVED"))
