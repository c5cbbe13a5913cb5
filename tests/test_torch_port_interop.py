"""The port's reference-checkpoint interop against the JAX package's.

``ndtpu_torch.interop.torch_weights`` (reference module -> port model) and
``export_torch`` (port model -> reference module, ``reference_state_dict``)
are held against ``ndtpu.interop`` on a reference-layout stand-in of every
model family, built here: an ``nn.Conv1d(k=1)`` for each pointwise layer,
``nn.Linear`` for the TNets' fc1..3, ``nn.BatchNorm1d`` for each norm,
under the attribute names that ``ndtpu/interop/torch_weights.py`` reads,
with seeded random weights and running statistics. The reference's own
code is not needed.

- Import: JAX's ``map_*`` of the stand-in, then ``load_jax_variables``,
  gives the port model the port's ``map_*`` gives it, bit for bit.
- Export: from flax variables drawn from a seed, JAX's ``export_*`` into
  stand-in A and the port's ``export_*`` of the same variables (through
  ``load_jax_variables``) into stand-in B give identical state dicts, and
  ``reference_state_dict`` equals A's in keys, shapes, types and values.
- A stand-in -> port -> stand-in round trip is exact.
"""
import sys

import numpy as np
import pytest
import torch
from torch import nn

from ndtpu import interop as jax_interop
from ndtpu_torch import interop
from ndtpu_torch.interop import reference_loader
from ndtpu_torch.models import (
    NDTNet,
    NDTNetClassification,
    NDTNetPPClassification,
    NDTNetPPSegmentation,
    NDTNetSegmentation,
    PointNet,
    PointNetClassification,
    PointNetSegmentation,
    ResidualConnection,
    TNet,
)
from ndtpu_torch.models.dense import Dense
from ndtpu_torch.models.norm import BatchNorm

C, F, FINE, COARSE = 4, 16, 12, 6

# family -> a small port model of it
PORT = {
    "tnet": lambda **kw: TNet(3, **kw),
    "backbone": lambda **kw: NDTNet(3, F, **kw),
    "backbone_pointnet": lambda **kw: PointNet(3, F, **kw),
    "pointnet_segmentation": lambda **kw: PointNetSegmentation(
        num_classes=C, feature_dim=F, device="cpu", **kw),
    "pointnet_classification": lambda **kw: PointNetClassification(
        num_classes=C, feature_dim=F, device="cpu", **kw),
    "ndtnet_segmentation": lambda **kw: NDTNetSegmentation(
        num_classes=C, feature_dim=F, device="cpu", **kw),
    "ndtnet_classification": lambda **kw: NDTNetClassification(
        num_classes=C, feature_dim=F, device="cpu", **kw),
    "residual_connection": lambda **kw: ResidualConnection(FINE, COARSE, **kw),
    "ndtnetpp_segmentation": lambda **kw: NDTNetPPSegmentation(
        num_classes=C, fine_res=FINE, coarse_res=COARSE, feature_dim=F,
        device="cpu", **kw),
    "ndtnetpp_classification": lambda **kw: NDTNetPPClassification(
        num_classes=C, fine_res=FINE, coarse_res=COARSE, feature_dim=F,
        device="cpu", **kw),
}
PAIRS = ("tnet", "backbone", "backbone_pointnet")  # JAX maps to (params, stats)


def fn_name(family):
    return "backbone" if family == "backbone_pointnet" else family


def mirror(module, name=""):
    """The reference layout of a port module: Conv1d(k=1) or (fc1..3)
    Linear for each Dense, BatchNorm1d for each BatchNorm, containers for
    the rest, under the same attribute names."""
    if isinstance(module, Dense):
        if name.startswith("fc"):
            return nn.Linear(module.in_features, module.out_features)
        return nn.Conv1d(module.in_features, module.out_features, 1)
    if isinstance(module, BatchNorm):
        return nn.BatchNorm1d(module.weight.shape[0])
    out = nn.Module()
    for child_name, child in module.named_children():
        setattr(out, child_name, mirror(child, child_name))
    return out


def stand_in(family, seed):
    """A reference-layout stand-in of ``family`` with random weights,
    BatchNorm scales, biases and running statistics from ``seed``."""
    module = mirror(PORT[family]())
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for key, t in module.state_dict().items():
            if key.endswith("num_batches_tracked"):
                continue
            if key.endswith("running_var"):
                t.copy_(torch.rand(t.shape, generator=g) + 0.5)
            else:
                t.copy_(torch.randn(t.shape, generator=g))
    return module


def jax_variables(family, module):
    """ndtpu.interop's map of the module as a flax variables dict."""
    out = getattr(jax_interop.torch_weights, f"map_{fn_name(family)}")(module)
    if family in PAIRS:
        out = {"params": out[0], "batch_stats": out[1]}
    return out


def jax_export(family, variables, module):
    fn = getattr(jax_interop.export_torch, f"export_{fn_name(family)}")
    if family in PAIRS:  # these return nothing
        fn(variables["params"], variables["batch_stats"], module)
    else:
        fn(variables, module)
    return module


def port_map(family):
    return getattr(interop, f"map_{fn_name(family)}")


def port_export(family):
    return getattr(interop, f"export_{fn_name(family)}")


def assert_same_state(a, b):
    """Two state dicts equal key by key and bit for bit, in type and
    shape."""
    assert list(a.keys()) == list(b.keys())
    for key in a:
        assert a[key].dtype == b[key].dtype, key
        assert a[key].shape == b[key].shape, key
        assert torch.equal(a[key], b[key]), key


def seeded_variables(tree, seed):
    """A flax variables tree of the same structure with values drawn from
    ``seed`` (running variances positive)."""
    rng = np.random.default_rng(seed)

    def draw(node, path=""):
        if isinstance(node, dict):
            return {k: draw(v, f"{path}/{k}") for k, v in node.items()}
        shape = np.asarray(node).shape
        if path.endswith("/var"):
            return (rng.random(shape) + 0.5).astype(np.float32)
        return rng.normal(size=shape).astype(np.float32)

    return draw(tree)


@pytest.mark.parametrize("family", list(PORT))
def test_import_matches_jax_bit_for_bit(family):
    module = stand_in(family, seed=1)
    want = interop.load_jax_variables(PORT[family](),
                                      jax_variables(family, module))
    got = port_map(family)(module, PORT[family]())
    assert_same_state(got.state_dict(), want.state_dict())
    # the state dict does as well as the module
    again = port_map(family)(module.state_dict(), PORT[family]())
    assert_same_state(again.state_dict(), want.state_dict())


@pytest.mark.parametrize("family", list(PORT))
def test_export_matches_jax_bit_for_bit(family):
    variables = seeded_variables(jax_variables(family, stand_in(family, 0)),
                                 seed=2)
    a = jax_export(family, variables, mirror(PORT[family]()))
    model = interop.load_jax_variables(PORT[family](), variables)
    b = port_export(family)(model, mirror(PORT[family]()))
    assert_same_state(b.state_dict(), a.state_dict())
    ref = interop.reference_state_dict(model)
    assert_same_state(ref, a.state_dict())


@pytest.mark.parametrize("family", list(PORT))
def test_round_trip_is_exact(family):
    module = stand_in(family, seed=3)
    model = port_map(family)(module, PORT[family]())
    back = port_export(family)(model, mirror(PORT[family]()))
    original = module.state_dict()
    assert_same_state(back.state_dict(), original)
    assert_same_state(interop.reference_state_dict(model), original)


def test_bf16_model_exports_float32_and_reimports():
    """A bfloat16 model's reference state is float32 (bf16 widens exactly)
    and maps back into a bfloat16 model unchanged."""
    model = port_map("ndtnet_segmentation")(
        stand_in("ndtnet_segmentation", 4),
        PORT["ndtnet_segmentation"](param_dtype=torch.bfloat16))
    ref = interop.reference_state_dict(model)
    floats = [k for k in ref if not k.endswith("num_batches_tracked")]
    assert all(ref[k].dtype == torch.float32 for k in floats)
    assert all(ref[k].dtype == torch.int64 and int(ref[k]) == 0
               for k in ref if k.endswith("num_batches_tracked"))
    back = port_map("ndtnet_segmentation")(
        ref, PORT["ndtnet_segmentation"](param_dtype=torch.bfloat16))
    assert_same_state(back.state_dict(), model.state_dict())


def test_map_refuses_another_family_and_another_layout():
    module = stand_in("ndtnet_segmentation", 5)
    with pytest.raises(TypeError, match="ndtnet_classification"):
        interop.map_ndtnet_classification(module,
                                          PORT["ndtnet_segmentation"]())
    with pytest.raises(TypeError):
        interop.export_tnet(PORT["ndtnet_segmentation"](), module)
    state = module.state_dict()
    short = {k: v for k, v in state.items() if "conv4" not in k}
    with pytest.raises(KeyError, match="conv4"):
        interop.map_ndtnet_segmentation(short, PORT["ndtnet_segmentation"]())
    wide = NDTNetSegmentation(num_classes=C + 1, feature_dim=F, device="cpu")
    with pytest.raises(ValueError, match="conv4.weight"):
        interop.map_ndtnet_segmentation(state, wide)


@pytest.fixture
def clean_ndnet_modules():
    """The loader registers ``ndnet`` modules; put sys.modules back."""
    saved = {k: v for k, v in sys.modules.items() if k.split(".")[0] == "ndnet"}
    for k in saved:
        del sys.modules[k]
    yield
    for k in [k for k in sys.modules if k.split(".")[0] == "ndnet"]:
        del sys.modules[k]
    sys.modules.update(saved)


def test_reference_loader_raises_naming_the_path(tmp_path, clean_ndnet_modules):
    where = tmp_path / "nowhere" / "ndnet" / "models"
    with pytest.raises(FileNotFoundError, match=str(where)):
        reference_loader.load_reference_module("ndtnet", str(where))
    assert reference_loader.DEFAULT_REF.endswith("reference/ndnet/models")


REFERENCE_NDTNETPP = '''
import torch
from ndnet.preprocessing.ndt_legacy import NDT_Sampler


class ResidualConnection(torch.nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + 1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """a dead duplicate"""


class ndnetClassification(torch.nn.Module):
    def __init__(self):
        super().__init()
'''


def test_reference_loader_stubs_and_patches(tmp_path, clean_ndnet_modules):
    """The ndt_legacy import is stubbed; the verbatim module keeps its
    bugs, the patched one (registered apart) has the real forward and a
    constructible ndnetClassification."""
    models = tmp_path / "ndnet" / "models"
    models.mkdir(parents=True)
    (models / "ndtnetpp.py").write_text(REFERENCE_NDTNETPP)
    verbatim = reference_loader.load_reference_module("ndtnetpp", str(models))
    assert verbatim.ResidualConnection()(torch.zeros(2)) is None
    with pytest.raises(AttributeError):
        verbatim.ndnetClassification()
    patched = reference_loader.load_reference_module("ndtnetpp", str(models),
                                                     patched=True)
    assert patched is not verbatim
    assert torch.equal(patched.ResidualConnection()(torch.zeros(2)),
                       torch.ones(2))
    patched.ndnetClassification()
