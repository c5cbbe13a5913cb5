"""Train and eval steps of NDT-Net segmentation, NDT-Net classification,
NDT-Net++ segmentation and the PointNet baseline (port of
``ndtpu/train/loop.py``).

A step is the JAX step's sequence in eager PyTorch: the NDT preprocessing
without a gradient (on the card one segment-moments kernel launch per
resolution, tagged with the ground truth's class slots where there is a
per-point ground truth), the train-mode forward to logits, softmax
cross-entropy from logits (over the kept NDs for segmentation), the
backward, and one Adam update at the schedule's rate (the PointNet step
has no preprocessing: the model takes the points). Metrics come back as
device scalars: nothing in the step after the preprocessing waits for the
card, and inside ``core.ndt._fixed_rounds()`` the preprocessing does not
either, so a step can be captured into a CUDA graph as it is.

``make_epoch_scan`` / ``run_epoch_scan`` are the port of the JAX
package's one-program epoch (a ``lax.scan`` over the steps, each gathering
its batch from the device-resident dataset): on the card, a CUDA graph of
one step replayed once a step; on the CPU, the same sync-free loop
without a graph.

Under a data group (``parallel/mesh.py::init_distributed``) each rank
holds a slice of every global batch and the steps compute the JAX
package's global-batch step, which XLA gets from a batch-sharded mesh:
BatchNorm's statistics are the global batch's (``models/norm.py``); the
loss is the global one, each rank back-propagating its share of the
global sum over the global count (a masked mean is not the mean of the
ranks' means: each cloud keeps its own number of NDs); the metrics are
all-reduced; the gradients are summed over the ranks in one flat
all-reduce before Adam, so every rank takes the same update. The
preprocessing stays local to each rank, with no collective, as
``_make_prep``'s ``shard_map`` pins it in the JAX package. Without a group
the steps compute the single-process expressions.
"""
from __future__ import annotations

import numpy as np
import torch

from ndtpu_torch.core.ndt import _fixed_rounds
from ndtpu_torch.data.loader import epoch_order, sharded_batch, to_device
from ndtpu_torch.parallel.collectives import all_reduce_gradients, all_reduce_sum
from ndtpu_torch.parallel.mesh import data_group
from ndtpu_torch.preprocessing.batch import ndt_preprocessing_with_state
from ndtpu_torch.train.state import make_capturable
from ndtpu_torch.utils.profiling import capturing, replayed, span


def make_lr_schedule(base_lr: float, steps_per_epoch: int,
                     decay_epochs: int = 20, decay_rate: float = 0.5):
    """Staircase decay, ``optax.exponential_decay(staircase=True)``: count
    -> base_lr * decay_rate ** (count // max(1, decay_epochs *
    steps_per_epoch)), in float32 as optax evaluates it. The count is the
    optimizer's step before the update."""
    transition = max(1, decay_epochs * steps_per_epoch)

    def schedule(count: int) -> float:
        p = np.float32(count // transition)
        return float(np.float32(base_lr) * np.power(np.float32(decay_rate), p))

    return schedule


def _cross_entropy(logits, onehot):
    """Each row's softmax cross-entropy."""
    return -(onehot * torch.log_softmax(logits, dim=-1)).sum(-1)


def _hits(logits, onehot):
    """1.0 where a row's argmax (the first maximum) matches the ground
    truth's, else 0.0 (float32)."""
    return (logits.argmax(-1) == onehot.argmax(-1)).to(torch.float32)


def _masked_sum(rows, mask):
    """(the sum of ``rows`` where ``mask`` keeps them, the kept rows)."""
    return torch.where(mask, rows, 0.0).sum(), mask.sum()


def cross_entropy_loss(logits, onehot, mask=None):
    """Mean softmax cross-entropy over the (optionally masked) rows; the
    masked mean divides by max(sum(mask), 1)."""
    ce = _cross_entropy(logits, onehot)
    if mask is None:
        return ce.mean()
    total, rows = _masked_sum(ce, mask)
    return total / torch.clamp(rows, min=1)


def accuracy(logits, onehot, mask=None):
    """Fraction of rows whose argmax (the first maximum) matches the
    ground truth's."""
    hit = _hits(logits, onehot)
    if mask is None:
        return hit.mean()
    total, rows = _masked_sum(hit, mask)
    return total / torch.clamp(rows, min=1)


def loss_and_metrics(logits, onehot, mask=None):
    """(the loss to back-propagate, {"loss", "accuracy"} of the batch as
    device scalars): ``cross_entropy_loss`` and ``accuracy``. Under a data
    group the batch is the global one: one all-reduce of [kept rows, hits,
    the sum of the loss] (detached, in at least float32), and each rank
    back-propagates its own sum over the global row count, so that the
    gradients summed over the ranks are the global loss's."""
    if data_group() is None:
        loss = cross_entropy_loss(logits, onehot, mask)
        with torch.no_grad():
            acc = accuracy(logits, onehot, mask)
        return loss, {"loss": loss.detach(), "accuracy": acc}
    ce = _cross_entropy(logits, onehot)
    if mask is None:
        mask = torch.ones(ce.shape, dtype=torch.bool, device=ce.device)
    local, rows = _masked_sum(ce, mask)
    wide = torch.promote_types(local.dtype, torch.float32)
    with torch.no_grad():
        hits = _masked_sum(_hits(logits, onehot), mask)[0]
        rows, hits, total = all_reduce_sum(torch.stack(
            [rows.to(wide), hits.to(wide), local.to(wide)]))
        denom = torch.clamp(rows, min=1)
    return local / denom.to(local.dtype), {
        "loss": (total / denom).to(local.dtype),
        "accuracy": (hits / denom).to(torch.float32)}


def _update(state, loss):
    """Backward of ``loss``, the gradients summed over the data group (if
    any), and one optimizer update."""
    with span("ndtpu.backward"):
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        all_reduce_gradients(state.model.parameters())
    with span("ndtpu.optimizer"):
        state.apply_gradients()


def _make_prep(n_desired_nds, n_classes, search):
    """The step's preprocessing, without a gradient: (points [B, N, 3],
    ground truth or None, optional [B] voxel sizes) -> (points, covs,
    one-hot, mask, NDTResult)."""

    def prep(points, gt, voxel_sizes=None):
        with torch.no_grad():
            return ndt_preprocessing_with_state(
                n_desired_nds, points, gt, n_classes, search=search,
                fixed_voxel_sizes=voxel_sizes,
            )

    return prep


def make_ndt_seg_step(n_desired_nds: int, n_classes: int,
                      search: str = "fast"):
    """(step, eval_step) for NDTNetSegmentation.

    ``step(state, points, gt, *voxel_sizes) -> (state, metrics)`` and
    ``eval_step(state, points, gt, *voxel_sizes) -> metrics``. points [B,
    N, 3]; gt the one-hot [B, N, C+1] or int class tags [B, N]; an optional
    trailing [B] of voxel sizes skips the search (the streaming regime).
    ``state`` is a ``TrainState`` (ndtpu_torch.train.state), updated in
    place. metrics: {"loss", "accuracy"} as device scalars.
    """
    prep = _make_prep(n_desired_nds, n_classes, search)

    def step(state, points, gt, *voxel_sizes):
        with span("ndtpu.step"):
            pcl, covs, onehot, mask, _ = prep(points, gt, *voxel_sizes)
            with span("ndtpu.forward"):
                logits = state.model.train()(pcl, covs, return_logits=True)
                loss, metrics = loss_and_metrics(logits, onehot, mask)
            _update(state, loss)
        return state, metrics

    def eval_step(state, points, gt, *voxel_sizes):
        pcl, covs, onehot, mask, _ = prep(points, gt, *voxel_sizes)
        with torch.no_grad():
            logits = state.model.eval()(pcl, covs, return_logits=True)
            return loss_and_metrics(logits, onehot, mask)[1]

    return step, eval_step


def make_classification_step(n_desired_nds: int, n_classes: int,
                             search: str = "fast"):
    """(step, eval_step) for NDTNetClassification (loop.py:346-386):
    ``step(state, points [B, N, 3], label_onehot [B, C]) -> (state,
    metrics)``, ``eval_step(state, points, label_onehot) -> metrics``. The
    preprocessing is untagged; the loss is the mean over the B clouds."""
    prep = _make_prep(n_desired_nds, n_classes, search)

    def step(state, points, label_onehot):
        with span("ndtpu.step"):
            pcl, covs, _, _, _ = prep(points, None)
            with span("ndtpu.forward"):
                logits = state.model.train()(pcl, covs, return_logits=True)
                loss, metrics = loss_and_metrics(logits, label_onehot)
            _update(state, loss)
        return state, metrics

    def eval_step(state, points, label_onehot):
        pcl, covs, _, _, _ = prep(points, None)
        with torch.no_grad():
            logits = state.model.eval()(pcl, covs, return_logits=True)
            return loss_and_metrics(logits, label_onehot)[1]

    return step, eval_step


def make_multiscale_seg_step(fine_res: int, coarse_res: int, n_classes: int,
                             search: str = "fast"):
    """(step, eval_step) for NDTNetPPSegmentation (loop.py:293-343): the
    fine and the coarse preprocessing, both tagged with the ground truth
    (gt one-hot [B, N, C+1] or int tags [B, N]); the fine state goes into
    the model for its mid-forward prune; the loss is over the fine kept
    NDs. Same signatures as ``make_classification_step``."""
    prep_fine = _make_prep(fine_res, n_classes, search)
    prep_coarse = _make_prep(coarse_res, n_classes, search)

    def preps(points, gt):
        p1, c1, gt1, m1, state1 = prep_fine(points, gt)
        p2, c2, _, _, _ = prep_coarse(points, gt)
        return (p1, c1, state1, p2, c2), gt1, m1

    def step(state, points, gt):
        with span("ndtpu.step"):
            inputs, gt1, m1 = preps(points, gt)
            with span("ndtpu.forward"):
                logits = state.model.train()(*inputs, return_logits=True)
                loss, metrics = loss_and_metrics(logits, gt1, m1)
            _update(state, loss)
        return state, metrics

    def eval_step(state, points, gt):
        inputs, gt1, m1 = preps(points, gt)
        with torch.no_grad():
            logits = state.model.eval()(*inputs, return_logits=True)
            return loss_and_metrics(logits, gt1, m1)[1]

    return step, eval_step


def make_pointnet_seg_step(n_classes: int | None = None):
    """(step, eval_step) for PointNetSegmentation (loop.py:246-290): no NDT
    anywhere. ``step(state, points [B, N, 3], gt) -> (state, metrics)``
    and ``eval_step(state, points, gt) -> metrics``, gt the one-hot [B, N,
    C+1] or, with ``n_classes`` given, int class tags [B, N], one-hot
    encoded on the device by a compare (a tag outside [0, n_classes] gives
    a zero row, as ``jax.nn.one_hot``). The loss is the mean over every
    point; metrics are device scalars, so the step makes no host sync."""

    def one_hot(gt):
        if n_classes is not None and gt.dim() == 2:
            classes = torch.arange(n_classes + 1, device=gt.device)
            return (gt[..., None] == classes).to(torch.float32)
        return gt

    def step(state, points, gt):
        with span("ndtpu.step"):
            onehot = one_hot(gt)
            with span("ndtpu.forward"):
                logits = state.model.train()(points, return_logits=True)
                loss, metrics = loss_and_metrics(logits, onehot)
            _update(state, loss)
        return state, metrics

    def eval_step(state, points, gt):
        onehot = one_hot(gt)
        with torch.no_grad():
            logits = state.model.eval()(points, return_logits=True)
            return loss_and_metrics(logits, onehot)[1]

    return step, eval_step


# eager steps on a side stream before a capture: lazy initialisation
# (Adam's moments, cuBLAS's workspace) must not happen inside the graph
WARMUP_STEPS = 3


def _snapshot(state):
    """The train state's values: the step, the model's parameters and
    buffers, the optimizer's per-parameter state (None where it has
    none yet)."""
    with torch.no_grad():
        return (state.step,
                [t.detach().clone() for t in state.model.state_dict().values()],
                {p: {k: v.clone() for k, v in s.items()}
                 for p, s in state.optimizer.state.items()})


def _restore(state, snap):
    """Write ``_snapshot``'s values back in place (the tensors a graph
    holds keep their addresses); optimizer state made since is reset to
    the fresh one's values (zero moments, step 0)."""
    step, tensors, opt = snap
    state.step = step
    with torch.no_grad():
        for t, v in zip(state.model.state_dict().values(), tensors):
            t.copy_(v)
        for p, s in state.optimizer.state.items():
            before = opt.get(p)
            for k, v in s.items():
                if before:
                    v.copy_(before[k])
                else:
                    v.zero_()


class _Graph:
    """One captured step: its static index buffer, the metrics of the last
    replay and their sums since ``zero``, and the records of its spans
    (``utils/profiling.py::capturing``), which each replay times."""

    def __init__(self, graph, idx, last, total, spans):
        self.graph, self.idx, self.last, self.total = graph, idx, last, total
        self.spans = spans


class EpochScan:
    """``make_epoch_scan``'s epoch: ``epoch(state, order, *arrays) ->
    (state, mean_metrics, last_metrics)`` for ``order`` [steps, B] int64
    dataset rows on the arrays' device; metrics are device scalars.

    Each step gathers its batch with ``index_select`` from the dataset's
    device arrays and runs ``step_fn`` inside ``_fixed_rounds()``, so
    nothing in it waits for the host. On the CPU that is a plain loop over
    the steps. On the card the first epoch of a (state, arrays, B) makes a
    train state's Adam capturable (``make_capturable``), warms up with
    WARMUP_STEPS steps on a side stream (a train state is restored to its
    values before them) and captures one step into a CUDA graph
    (``torch.cuda.graph``, global capture mode) with a static index
    buffer; then each step is a device copy of its order row into that
    buffer, a fill of the step's rate (train) and one replay, which also
    adds the step's metrics to sums that live in the graph. The capture
    runs inside ``utils/profiling.py::capturing()``: the step's spans are
    event-record nodes of the graph that time every replay, and
    ``spans()`` reads the last one. A capture that fails raises. The
    graph holds the state's tensors by address: the state must not be
    replaced (restore a checkpoint before the first epoch). A kernel
    wrapper counts no launch at the capture, which launches nothing; a
    replay launches the captured kernels without calling their wrappers.

    With ``sharding`` (the data group) the arrays are this rank's block of
    a ``DeviceCachedDataset`` sharded over it, ``order`` holds global rows,
    and each step assembles this rank's slice of its global batch with one
    all-reduce an array (``data/loader.py::sharded_batch``). Under a data
    group the graph is captured in thread-local mode: NCCL's watchdog
    thread queries the events of earlier collectives while this thread
    captures, which global mode forbids; the warm-up steps have made the
    communicator before the capture."""

    def __init__(self, step_fn, train: bool, sharding=None):
        self.step_fn, self.train, self.sharding = step_fn, train, sharding
        self.graphs = {}

    def run_step(self, state, idx, arrays):
        if self.sharding is None:
            batch = tuple(a.index_select(0, idx) for a in arrays)
        else:
            batch = sharded_batch(arrays, idx, self.sharding)
        with _fixed_rounds():
            if self.train:
                return self.step_fn(state, *batch)[1]
            return self.step_fn(state, *batch)

    def __call__(self, state, order, *arrays):
        steps = order.shape[0]
        if steps == 0:
            raise ValueError("an epoch needs at least one batch")
        with span("ndtpu.epoch"):
            if order.device.type != "cuda":
                total = None
                for row in order:
                    last = self.run_step(state, row, arrays)
                    total = (dict(last) if total is None else
                             {k: total[k] + last[k] for k in total})
            else:
                g = self._graph(state, arrays, order.shape[1])
                for t in g.total.values():
                    t.zero_()
                for s in range(steps):
                    g.idx.copy_(order[s])
                    if self.train:
                        state.set_rate(state.step + s)
                    g.graph.replay()
                replayed(g.spans)
                if self.train:
                    state.step += steps
                last = {k: v.clone() for k, v in g.last.items()}
                total = g.total
        return state, {k: v / steps for k, v in total.items()}, last

    def _graph(self, state, arrays, b):
        key = (id(state), tuple(a.data_ptr() for a in arrays), b)
        if key not in self.graphs:
            self.graphs[key] = self._capture(state, arrays, b)
        return self.graphs[key]

    def _capture(self, state, arrays, b):
        dev = arrays[0].device
        idx = torch.arange(b, device=dev)
        if self.train:
            make_capturable(state)
        snap = _snapshot(state) if self.train else None
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
                last = self.run_step(state, idx, arrays)
        torch.cuda.current_stream(dev).wait_stream(side)
        if snap is not None:
            _restore(state, snap)
        total = {k: torch.zeros_like(v) for k, v in last.items()}
        graph = torch.cuda.CUDAGraph()
        mode = "global" if data_group() is None else "thread_local"
        with torch.cuda.graph(graph, capture_error_mode=mode):
            with capturing() as spans:
                last = self.run_step(state, idx, arrays)
            for k, v in last.items():
                total[k].add_(v)
        if snap is not None:
            state.step = snap[0]  # the capture ran apply_gradients' host part
        return _Graph(graph, idx, last, total, spans)


def make_epoch_scan(step_fn, train: bool = True, sharding=None) -> EpochScan:
    """A whole epoch of ``step_fn`` (a train step of ``make_*_step`` when
    ``train``, else an eval step, whose state passes through) over a
    device-resident dataset: ``epoch(state, order [steps, B], *arrays) ->
    (state, mean_metrics, last_metrics)`` (``EpochScan``); ``sharding``
    the data group over which the dataset is sharded, or None."""
    return EpochScan(step_fn, train, sharding)


def run_epoch_scan(epoch_fn, state, dataset, batch_size: int,
                   shuffle: bool = True, seed: int = 0):
    """Drive ``make_epoch_scan`` over a ``DeviceCachedDataset``: the
    epoch's [steps, B] order is ``batch_iterator``'s (``epoch_order``, the
    partial batch dropped), copied to the device from pinned memory
    without a sync; the metrics are read once, at the end. Returns (state,
    {last_*, mean_*} floats), ``run_epoch``'s format. A sharded dataset
    needs a scan made with its sharding, and every rank of it runs the
    same epoch."""
    if dataset.sharding is not epoch_fn.sharding:
        raise ValueError("the epoch scan's sharding is not the dataset's")
    n = len(dataset)
    steps = n // batch_size
    order = epoch_order(n, shuffle, seed)[:steps * batch_size]
    order = to_device((order.reshape(steps, batch_size),),
                      dataset.arrays[0].device)[0]
    state, mean, last = epoch_fn(state, order, *dataset.arrays)
    values = torch.stack(list(last.values()) + list(mean.values())).tolist()
    k = len(last)
    return state, {**{f"last_{m}": v for m, v in zip(last, values[:k])},
                   **{f"mean_{m}": v for m, v in zip(mean, values[k:])}}
