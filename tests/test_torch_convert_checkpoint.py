"""The port's reference-checkpoint converter
(``unidet3d_tpu_torch/tools/convert_checkpoint.py``) against the JAX package's
``convert_torch_state_dict`` followed by the port's ``weights.from_flax``, on
synthetic state dicts with the reference's exact key set
(``data/synthetic.py::reference_state_dict``, the twin of
``tests/test_convert_checkpoint.py::_make_reference_state_dict``), at small
and at production widths: equal key by key, bit for bit, and loadable
strictly into ``UniDet3D``; the real-checkpoint key variants (a ``module.``
prefix, ``num_batches_tracked``, extras, a missing key); the spconv layouts;
and the CLI."""
import numpy as np
import pytest
import torch

from tests.test_convert_checkpoint import _make_reference_state_dict
from unidet3d_tpu.tools import convert_checkpoint as jax_convert
from unidet3d_tpu_torch.core.class_table import build_class_table
from unidet3d_tpu_torch.core.config import DATASETS_CLASSES, default_config
from unidet3d_tpu_torch.data.synthetic import reference_state_dict
from unidet3d_tpu_torch.models.detector import UniDet3D
from unidet3d_tpu_torch.tools import convert_checkpoint
from unidet3d_tpu_torch.train.checkpoint import restore_params
from unidet3d_tpu_torch.weights import from_flax

N_CLS = 100  # the unified class table's classes + 1 (no object)
# (planes, d_model, heads, layers): small, and the production widths.
WIDTHS = {
    "small": ((4, 8), 16, 2, 2),
    "production": ((32, 64, 96, 128, 160), 256, 8, 6),
}


@pytest.fixture(scope="module", params=sorted(WIDTHS))
def case(request):
    planes, d, heads, layers = WIDTHS[request.param]
    sd = reference_state_dict(planes, d, layers, N_CLS)
    report = {}
    mine = convert_checkpoint.convert_state_dict(sd, num_levels=len(planes),
                                                 num_layers=layers, d_model=d, report=report)
    ref = from_flax(jax_convert.convert_torch_state_dict(
        sd, num_levels=len(planes), num_layers=layers, d_model=d, num_heads=heads))
    return dict(widths=(planes, d, heads, layers), sd=sd, mine=mine, ref=ref, report=report)


def test_converter_equals_jax_then_from_flax_bit_for_bit(case):
    mine, ref = case["mine"], case["ref"]
    assert mine.keys() == ref.keys()
    for k in ref:
        assert mine[k].dtype == ref[k].dtype == torch.float32, k
        assert mine[k].shape == ref[k].shape, k
        assert torch.equal(mine[k], ref[k]), k
    assert case["report"] == {"unexpected": [], "consumed": len(case["sd"])}


def test_converted_state_dict_loads_strictly(case):
    planes, d, heads, layers = case["widths"]
    cfg = default_config(num_planes=planes, d_model=d, num_heads=heads, num_layers=layers,
                         hidden_dim=4 * d)
    net = UniDet3D(cfg, build_class_table(DATASETS_CLASSES), device="cpu")
    net.load_state_dict(case["mine"], strict=True)
    for k, v in net.state_dict().items():
        assert torch.equal(v, case["mine"][k]), k


def test_synthetic_reference_matches_the_jax_tests_helper():
    planes, d, heads, layers = WIDTHS["small"]
    mine = reference_state_dict(planes, d, layers, N_CLS)
    ref = _make_reference_state_dict(planes, d, heads, layers, n_cls=N_CLS)
    assert list(mine) == list(ref)
    for k in ref:
        assert torch.equal(mine[k], ref[k]), k


def test_key_variants_are_stripped_reported_or_raised():
    planes, d, heads, layers = WIDTHS["small"]
    sd = reference_state_dict(planes, d, layers, N_CLS)
    kw = dict(num_levels=len(planes), num_layers=layers, d_model=d)
    base = convert_checkpoint.convert_state_dict(sd, **kw)

    wrapped = {f"module.{k}": v for k, v in sd.items()}
    wrapped["module.output_layer.0.num_batches_tracked"] = torch.tensor(3)
    wrapped["module.decoder.extra_head.weight"] = torch.zeros(2)
    report, ref_report = {}, {}
    out = convert_checkpoint.convert_state_dict(wrapped, report=report, **kw)
    jax_convert.convert_torch_state_dict(wrapped, num_heads=heads, report=ref_report, **kw)
    assert report == ref_report
    assert report["unexpected"] == ["decoder.extra_head.weight"]
    assert out.keys() == base.keys() and all(torch.equal(out[k], base[k]) for k in base)

    missing = dict(sd)
    del missing["unet.blocks.block0.conv_branch.2.weight"]
    with pytest.raises(KeyError, match="closest present keys"):
        convert_checkpoint.convert_state_dict(missing, **kw)
    with pytest.raises(KeyError, match="wrong architecture flags"):
        convert_checkpoint.convert_state_dict({"foo": torch.zeros(1)}, **kw)


@pytest.mark.parametrize("shape, k", [((8, 3, 3, 3, 4), 3), ((3, 3, 3, 4, 8), 3),
                                      ((16, 2, 2, 2, 8), 2), ((2, 2, 2, 8, 16), 2),
                                      ((8, 1, 1, 1, 4), 1)])
def test_conv_kernel_layouts_match_jax(shape, k):
    w = np.random.RandomState(0).randn(*shape).astype(np.float32)
    np.testing.assert_array_equal(convert_checkpoint._conv_kernel(w, k),
                                  jax_convert._conv_kernel(w, k))
    with pytest.raises(ValueError, match="unexpected conv weight shape"):
        convert_checkpoint._conv_kernel(w[..., None], k)


def test_cli_writes_a_params_file_and_reports(tmp_path, capsys):
    planes, d, heads, layers = WIDTHS["small"]
    sd = reference_state_dict(planes, d, layers, N_CLS)
    sd["decoder.extra_head.weight"] = torch.zeros(2)
    src, dst = tmp_path / "unidet3d.pth", tmp_path / "out" / "converted.pth"
    torch.save({"state_dict": sd, "meta": {"epoch": 1024}}, src)
    convert_checkpoint.main([str(src), str(dst), "--planes", *map(str, planes),
                             "--d-model", str(d), "--heads", str(heads),
                             "--layers", str(layers)])
    printed = capsys.readouterr().out.splitlines()
    assert printed[0] == f"converted {len(sd) - 1} tensors -> {dst}"
    assert printed[1].startswith("WARNING: 1 checkpoint keys were not consumed")
    assert printed[2] == "  - decoder.extra_head.weight"
    want = convert_checkpoint.convert_state_dict(
        {k: v for k, v in sd.items() if k != "decoder.extra_head.weight"},
        num_levels=len(planes), num_layers=layers, d_model=d)
    got = restore_params(str(dst))
    assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want)
