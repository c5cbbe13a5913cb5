"""The eval-mode Dense bias + BatchNorm (+ ReLU) epilogue
(``ops/epilogue.py``, ``models/dense.py::dense_norm``): its plain version
and its dispatch on the CPU against the modules' chain, bit for bit; the
CUDA kernel against the chain on the card (the ``cuda`` tests). This file
imports neither jax nor ``ndtpu``, so the card's machine runs it:

    python -m pytest --noconftest tests/test_torch_port_epilogue.py -q
"""
import numpy as np
import pytest
import torch

from ndtpu_torch.models import dense
from ndtpu_torch.models.dense import Dense, dense_norm
from ndtpu_torch.models.ndtnet import NDTNetSegmentation
from ndtpu_torch.models.norm import BatchNorm
from ndtpu_torch.ops import epilogue

WIDTHS = (64, 128, 256, 512, 768, 1024)  # every site's C in NDT-Net
SPECIALS = (float("nan"), float("inf"), float("-inf"), -0.0, 0.0)


def site(c, seed=0, in_dim=8, device="cpu", dtype=None, param_dtype=torch.float32):
    """A Dense(in_dim, c) and an eval BatchNorm(c) with random parameters
    and running statistics (variances from 1e-3 to 10); every 7th channel
    has mean 0, a negative weight and shift -0.0, so that a product the
    bias cancels comes out -0.0 there."""
    g = torch.Generator().manual_seed(seed)
    conv = Dense(in_dim, c, dtype, param_dtype)
    bn = BatchNorm(c, dtype=dtype, param_dtype=param_dtype)
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=g))
        conv.bias.copy_(torch.randn(c, generator=g))
        bn.weight.copy_(torch.randn(c, generator=g))
        bn.bias.copy_(torch.randn(c, generator=g))
        bn.running_mean.copy_(torch.randn(c, generator=g))
        bn.running_var.copy_(10.0 ** torch.empty(c).uniform_(-3, 1, generator=g))
        bn.running_mean[::7] = 0.0
        bn.weight[::7] = -bn.weight[::7].abs()
        bn.bias[::7] = -0.0
    return conv.to(device), bn.to(device).eval()


def special_rows(conv, rows, seed=0):
    """[rows, C] f32 normals on the Dense's device; the first rows hold
    NaN, +-inf, -0.0 and 0.0 in turns, the next one minus the Dense's
    bias (sums of exactly 0)."""
    dev = conv.weight.device
    g = torch.Generator(dev).manual_seed(seed)
    y = torch.randn(rows, conv.out_features, generator=g, device=dev)
    for r, v in enumerate(SPECIALS):
        y[r, r::len(SPECIALS)] = v
    y[len(SPECIALS)] = -conv.bias.detach()
    return y


def vectors(conv, bn):
    return (conv.bias, bn.running_mean, torch.sqrt(bn.running_var + bn.eps),
            bn.weight, bn.bias)


def chain(conv, bn, y, relu):
    """Today's ops on a product ``y``: Dense's bias add, the module's
    eval BatchNorm, ``torch.relu``."""
    out = bn(y + conv.bias)
    return torch.relu(out) if relu else out


def bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("c", WIDTHS)
def test_plain_twin_equals_the_chain_bit_for_bit(c, relu):
    conv, bn = site(c, seed=c)
    y = special_rows(conv, 64, seed=c)
    with torch.no_grad():
        want = chain(conv, bn, y, relu)
        got = epilogue.dense_bn_act_plain(y, *vectors(conv, bn), relu)
    assert torch.equal(bits(got), bits(want))
    assert bool(want.isnan().any()) and bool(want.isinf().any())
    zeros = want[len(SPECIALS), ::7]  # -0.0 before the ReLU
    assert bool((zeros == 0).all()) and (relu or bool(torch.signbit(zeros).all()))


# the cases dense_norm tells apart: only "eval" takes the kernel
CASES = ("eval", "train", "grad", "bfloat16", "bf16_params", "float64",
         "c_not_a_multiple_of_4")


def case_site(case, device="cpu"):
    """A Dense -> BatchNorm site and an input [3, 5, 8] set up as ``case``
    says (the BatchNorm in train mode for "train"; gradients are the
    caller's)."""
    dtype = {"bfloat16": torch.bfloat16, "float64": torch.float64}.get(case)
    param_dtype = torch.bfloat16 if case == "bf16_params" else torch.float32
    conv, bn = site(30 if case == "c_not_a_multiple_of_4" else 64, dtype=dtype,
                    param_dtype=param_dtype, device=device)
    if case == "train":
        bn.train()
    return conv, bn, torch.randn(3, 5, 8, device=device)


@pytest.mark.parametrize("case", CASES)
def test_dense_norm_takes_the_chain_where_it_must(case, monkeypatch):
    """With the wrapper raising, dense_norm on CPU tensors (in eval mode
    too), in train mode, with gradients on, in bfloat16 and float64, with
    bfloat16 parameters and at a C the kernel does not take gives the
    modules' ops bit for bit."""
    def refuse(*args, **kwargs):
        raise AssertionError("the epilogue kernel was taken")

    monkeypatch.setattr(dense, "dense_bn_act", refuse)
    conv, bn, x = case_site(case)
    with torch.set_grad_enabled(case == "grad"):
        assert not dense.takes_kernel(conv, bn, x)
        for relu in (False, True):
            want = bn(conv(x))
            want = torch.relu(want) if relu else want
            got = dense_norm(conv, bn, x, relu)
            assert torch.equal(got, want)
            assert got.requires_grad == (case == "grad")


def test_eval_segmentation_on_cpu_matches_the_chain():
    """An eval NDTNetSegmentation on the CPU (every site through
    dense_norm) gives the logits of the modules' ops composed by hand, bit
    for bit."""
    torch.manual_seed(0)
    model = NDTNetSegmentation(num_classes=4, feature_dim=32, device="cpu").eval()
    with torch.no_grad():
        for bn in (m for m in model.modules() if isinstance(m, BatchNorm)):
            bn.running_mean.normal_()
            bn.running_var.uniform_(0.5, 2.0)
            bn.weight.normal_()
            bn.bias.normal_()
    rng = np.random.default_rng(0)
    pts = torch.from_numpy(rng.normal(size=(2, 40, 3)).astype(np.float32))
    covs = torch.from_numpy(rng.normal(size=(2, 40, 9)).astype(np.float32))
    with torch.no_grad():
        got = model(pts, covs, return_logits=True)
        want = by_hand(model, pts, covs)
    assert torch.equal(bits(got), bits(want))


def by_hand(model, pts, covs):
    """NDTNetSegmentation's eval forward with every Dense -> BatchNorm
    site written out as the modules' ops."""
    def site_ops(conv, bn, x, relu):
        y = bn(conv(x))
        return torch.relu(y) if relu else y

    def tnet(t, x):
        h = site_ops(t.conv1, t.bn1, x, True)
        h = site_ops(t.conv2, t.bn2, h, True)
        h = site_ops(t.conv3, t.bn3, h, True).amax(dim=1)
        h = site_ops(t.fc1, t.bn4, h, True)
        h = t.fc3(site_ops(t.fc2, t.bn5, h, True))
        return (h + torch.eye(t.in_dim).reshape(-1)).reshape(-1, t.in_dim, t.in_dim)

    fe = model.feature_extractor
    b, n, _ = pts.shape
    t = tnet(fe.t1, pts)
    x = torch.cat([torch.einsum("bij,bnj->bni", t, pts),
                   torch.einsum("bij,bnjk->bnik", t,
                                covs.reshape(b, n, 3, 3)).reshape(b, n, 9)], -1)
    x = site_ops(fe.conv1, fe.bn1, x, False)
    x = torch.einsum("bnj,bji->bni", x, tnet(fe.t2, x))
    x_t2 = x
    x = site_ops(fe.conv3, fe.bn3, site_ops(fe.conv2, fe.bn2, x, False), False)
    x = torch.cat([x_t2, x.amax(dim=1, keepdim=True).expand_as(x)], -1)
    for conv, bn in ((model.conv1, model.bn1), (model.conv2, model.bn2),
                     (model.conv3, model.bn3)):
        x = site_ops(conv, bn, x, True)
    return model.conv4(x)


@pytest.mark.parametrize("fault,match", [
    ("dtype", "float32"), ("vector_dtype", "float32"),
    ("non_contiguous", "contiguous"), ("vector_shape", "shape"),
    ("c_not_a_multiple_of_4", "multiple of 4"), ("cpu", "CUDA tensor"),
])
def test_wrapper_raises_on_what_the_kernel_does_not_take(fault, match):
    """The wrapper refuses, before any launch, each input the kernel does
    not take; a well-formed input on the CPU is refused for its device
    alone."""
    c = 30 if fault == "c_not_a_multiple_of_4" else 64
    conv, bn = site(c)
    y = torch.randn(16, c)
    vecs = list(vectors(conv, bn))
    if fault == "dtype":
        y = y.double()
    elif fault == "vector_dtype":
        vecs[2] = vecs[2].double()
    elif fault == "non_contiguous":
        y = torch.randn(c, 16).t()
    elif fault == "vector_shape":
        vecs[1] = torch.zeros(c + 4)
    before = epilogue.dense_bn_act.launches
    with pytest.raises((TypeError, ValueError), match=match):
        epilogue.dense_bn_act(y, *vecs, True)
    assert epilogue.dense_bn_act.launches == before


@pytest.mark.parametrize("rows,c", [(512000, 64), (512000, 768), (512000, 1024),
                                    (512, 256), (4097, 128), (1, 64),
                                    (4096, 4080), (8192, 8160), (3, 12)])
def test_plan_gives_each_thread_one_column_group(rows, c):
    """The grid's threads are a multiple of C/4 (a thread's float4s all
    lie in one column group), and the grid is one wave of the H100's 132
    SMs where a wave holds a whole multiple of C/4."""
    blocks = epilogue.epilogue_plan(rows, c, 132)
    c4, wave = c // 4, 132 * epilogue.BLOCKS_PER_SM
    m = c4 // np.gcd(c4, epilogue.THREADS)
    assert blocks >= 1 and blocks * epilogue.THREADS % c4 == 0
    assert blocks <= max(m, wave)
    # one pass of UNROLL float4s a thread covers the rows, or the wave is full
    assert (blocks * epilogue.THREADS * epilogue.UNROLL >= rows * c4
            or blocks > wave - m)


# --- on the card ---------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# (C, ReLU) of every Dense -> BatchNorm site of a serving request: the
# T-Nets' conv1-3, the backbone's conv1-3 (no ReLU), the head's conv1-3
SERVE_SITES = ((64, True), (128, True), (1024, True), (64, False),
               (128, False), (768, False), (512, True), (256, True),
               (128, True))


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [512000, 4097, 512])
@pytest.mark.parametrize("c,relu", sorted(set(SERVE_SITES)))
def test_kernel_matches_the_chain_bit_for_bit_on_the_card(cuda, rows, c, relu):
    """The kernel against the modules' ops on the card, every serving
    site's (C, ReLU) at a request's 512,000 rows, a ragged 4097 and the
    T-Nets' 512-row fc widths, on rows holding NaN, +-inf, -0.0 and
    products the bias cancels; one launch a call."""
    conv, bn = site(c, seed=rows + c, device="cuda")
    y = special_rows(conv, rows, seed=c)
    before = epilogue.dense_bn_act.launches
    with torch.no_grad():
        got = epilogue.dense_bn_act(y, *vectors(conv, bn), relu)
        want = chain(conv, bn, y, relu)
    torch.cuda.synchronize()
    assert epilogue.dense_bn_act.launches - before == 1
    assert torch.equal(bits(got), bits(want))


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_dense_norm_on_the_card_launches_only_in_eval(cuda, case):
    """dense_norm on the card: in eval float32 without gradients one
    launch, in every other case none; the result is the modules' ops bit
    for bit either way."""
    conv, bn, x = case_site(case, device="cuda")
    with torch.set_grad_enabled(case == "grad"):
        assert dense.takes_kernel(conv, bn, x) == (case == "eval")
        for relu in (False, True):
            before = epilogue.dense_bn_act.launches
            got = dense_norm(conv, bn, x, relu)
            launched = epilogue.dense_bn_act.launches - before
            want = bn(conv(x))
            want = torch.relu(want) if relu else want
            assert launched == (case == "eval")
            assert torch.equal(got, want)


def serving_batch(clouds=4, points=20000, seed=1):
    from ndtpu_torch.data.synthetic import make_batch

    return make_batch(clouds, points, seed=seed)


@pytest.mark.cuda
def test_pipeline_logits_identical_with_kernel_and_chain(cuda, monkeypatch):
    """SegmentationPipeline at the serving widths (768 features, 28
    classes): a request's logits with the kernel and with every site
    switched to the chain (``takes_kernel`` patched) agree bit for bit,
    and a request launches the kernel exactly 16 times (12 per-point
    sites, the T-Nets' 4 fc sites)."""
    from ndtpu_torch.serve import SegmentationPipeline

    pipe = SegmentationPipeline(256, 28, 768, device="cuda")
    pts = serving_batch()
    pipe(pts)  # warm-up: builds the kernel
    before = epilogue.dense_bn_act.launches
    fused = pipe(pts)[0]
    torch.cuda.synchronize()
    assert epilogue.dense_bn_act.launches - before == 16
    monkeypatch.setattr(dense, "takes_kernel", lambda *args: False)
    plain = pipe(pts)[0]
    assert epilogue.dense_bn_act.launches - before == 16
    assert torch.equal(bits(fused), bits(plain))


@pytest.mark.cuda
def test_no_launch_in_a_graph_epoch_step_or_an_eager_multiscale_step(cuda):
    """Training never takes the kernel: a graph epoch of the segmentation
    step (its warm-up steps, the capture, the replays) and an eager
    NDT-Net++ step (chip_smoke's card-vs-CPU check) count no launch and
    capture none."""
    import pathlib
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
    import chip_smoke
    from ndtpu_torch.data.loader import DeviceCachedDataset
    from ndtpu_torch.train.loop import make_epoch_scan, make_ndt_seg_step, run_epoch_scan
    from ndtpu_torch.train.state import create_train_state

    pts = np.stack([chip_smoke.example_cloud(1, 8192, seed=s)[0] for s in range(8)])
    labels = (1 + (pts[..., 0] > 0) + 2 * (pts[..., 1] > 0)).astype(np.int32)
    ds = DeviceCachedDataset(list(zip(pts, labels)), "cuda")
    step, _ = make_ndt_seg_step(256, 4, "probe")
    before = (epilogue.dense_bn_act.launches, epilogue.dense_bn_act.captured)
    state = create_train_state(4, 64, lambda _: 1e-3)
    run_epoch_scan(make_epoch_scan(step), state, ds, 4, True, 0)
    chip_smoke.small_multiscale_step_check()
    torch.cuda.synchronize()
    assert (epilogue.dense_bn_act.launches, epilogue.dense_bn_act.captured) == before
