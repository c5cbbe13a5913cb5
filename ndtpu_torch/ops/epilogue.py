"""The eval-mode pointwise epilogue of a Dense -> BatchNorm (-> ReLU) site:
CUDA kernel, plain version, wrapper.

``dense_bn_act(y, bias, mean, denom, weight, shift, relu)`` takes the
Dense's product ``y`` [..., C] (``models/dense.py::Dense.product``) and
computes, element by element, the chain that the modules run in eval
mode, each step rounded to f32 in this order:

    t = y + bias          (Dense.forward)
    t = t - mean          (BatchNorm.forward in eval mode, on its
    t = t / denom          running statistics: denom is
    t = t * weight         sqrt(running_var + eps), the [C] torch op
    t = t + shift          the module runs)

then ``torch.relu`` where ``relu``. The kernel is
``ndtpu_torch/csrc/pointwise_epilogue.cu`` (its comments say what bounds
it on an H100 and how it is laid out); it replaces no TPU kernel, since
XLA fuses this chain on the TPU. The wrapper checks its inputs (CUDA
tensors only) and launches one pass on the current stream, counting the
launch in its ``launches`` attribute, or in ``captured`` for a call
captured into a CUDA graph, which launches nothing: each replay then
launches it without the wrapper. The result is a new tensor; the plain
version ``dense_bn_act_plain`` and the kernel agree bit for bit.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from ndtpu_torch.ops import _build

SOURCE = "pointwise_epilogue.cu"
THREADS = 256        # threads a block (kThreads in the source)
BLOCKS_PER_SM = 4    # resident blocks an SM (kBlocksPerSM)
UNROLL = 4           # float4 loads in flight a thread (kUnroll)


def dense_bn_act_plain(y, bias, mean, denom, weight, shift, relu: bool):
    """The chain in plain PyTorch: the ops ``Dense`` and eval-mode
    ``BatchNorm`` run, in their order, then ``torch.relu``."""
    t = y + bias
    t = (t - mean) / denom
    t = t * weight + shift
    return torch.relu(t) if relu else t


def epilogue_plan(rows: int, channels: int, sms: int) -> int:
    """The kernel's grid: blocks of THREADS threads, a multiple of
    ``m = (C/4) / gcd(C/4, THREADS)`` so the grid's threads are a multiple
    of C/4 (each thread then keeps one column group), enough for UNROLL
    float4s a thread where the rows are few, at most one wave of
    BLOCKS_PER_SM blocks an SM (rounded down to a multiple of m, at least
    m)."""
    c4 = channels // 4
    m = c4 // math.gcd(c4, THREADS)
    want = -(-rows * c4 // (THREADS * UNROLL))
    return m * max(1, min(-(-want // m), sms * BLOCKS_PER_SM // m))


@functools.cache
def _entry():
    """Build the source (at first use) and bind its entry."""
    fn = _build.load(SOURCE).ndtpu_dense_bn_act
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    return fn


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(y, vectors):
    """The wrapper's input checks; returns C."""
    if y.dim() < 1:
        raise ValueError("y must be [..., C]")
    c = y.shape[-1]
    if c % 4:
        raise ValueError(f"C must be a multiple of 4, got {c}")
    for name, t in (("y", y),) + vectors:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected torch.float32, got {t.dtype}")
        if t.device != y.device:
            raise ValueError(f"{name}: expected device {y.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
        if t is not y and tuple(t.shape) != (c,):
            raise ValueError(f"{name}: expected shape ({c},), got {tuple(t.shape)}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: must be 16-byte aligned")
    if not y.is_cuda:
        raise ValueError(f"y: expected a CUDA tensor, got {y.device} (the "
                         "plain version is dense_bn_act_plain)")
    return c


def dense_bn_act(y, bias, mean, denom, weight, shift, relu: bool):
    """The epilogue (module docstring) of ``y`` [..., C] f32, contiguous,
    C a multiple of 4, with the [C] f32 vectors ``bias`` (the Dense's),
    ``mean`` (running_mean), ``denom`` (sqrt(running_var + eps)),
    ``weight`` and ``shift`` (the BatchNorm's weight and bias), all on
    ``y``'s device, a CUDA device. One kernel launch. Raises on anything
    else."""
    c = _check(y, (("bias", bias), ("mean", mean), ("denom", denom),
                   ("weight", weight), ("shift", shift)))
    out = torch.empty_like(y)
    rows = y.numel() // c
    if rows == 0:  # nothing to compute: no launch
        return out
    index = y.device.index if y.device.index is not None else torch.cuda.current_device()
    err = _entry()(
        y.data_ptr(), bias.data_ptr(), mean.data_ptr(), denom.data_ptr(),
        weight.data_ptr(), shift.data_ptr(), out.data_ptr(), rows, c,
        int(bool(relu)), epilogue_plan(rows, c, _sms(index)),
        torch.cuda.current_stream(y.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dense_bn_act kernel launch failed: CUDA error {err}")
    if torch.cuda.is_current_stream_capturing():  # each replay launches it
        dense_bn_act.captured += 1
    else:
        dense_bn_act.launches += 1
    return out


dense_bn_act.launches = 0
dense_bn_act.captured = 0
