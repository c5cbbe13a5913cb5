"""Accuracy-parity experiment: the port against the torch reference (port
of ``tools/parity_train.py``).

    python -m ndtpu_torch.tools.parity_train --device cpu --epochs 1 \\
        --train_size 8 --test_size 8 --n_samples 512 --n_desired_nds 64 \\
        --feature_dim 32 --batch_size 4

The controlled form of the north-star experiment (classification accuracy
at parity with the reference at n_desired_nds 1000): both models train on
the same synthetic set (SyntheticCls or SyntheticSeg, the reference's
datasets being absent), on identical tensors preprocessed once by the
port, with the same optimizer (Adam, same lr, betas and eps), the same
batch order (seeded permutations) and the same initial weights: the
reference model's random init (torch seed ``--seed``) is carried into the
port's model by ``interop.torch_weights`` before either trains. The
framework is the only factor that varies.

The reference model comes from the reference's own code
(``interop.reference_loader``, ``ndnet/models/ndtnet.py:166-243``); the
tool raises ``FileNotFoundError`` where that code is absent. The
reference side trains as its tools/train.py:16-92 does, on the CPU; its
loss defaults to the documented intent (cross-entropy over the class
axis), and ``--torch_loss literal`` selects its verbatim call (over the
wrong axis, its train.py:72). The port side trains on ``--device``. The
last line is a JSON object with both sides' curves and accuracies
(``"ndtpu_torch"`` and ``"torch_reference"``).
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from ndtpu_torch.data.synthetic import SyntheticCls, SyntheticSeg
from ndtpu_torch.interop import reference_loader
from ndtpu_torch.interop.torch_weights import (
    map_ndtnet_classification,
    map_ndtnet_segmentation,
)
from ndtpu_torch.models.ndtnet import NDTNetClassification, NDTNetSegmentation
from ndtpu_torch.preprocessing.batch import ndt_preprocessing_with_state
from ndtpu_torch.train.loop import accuracy, cross_entropy_loss
from ndtpu_torch.utils.device import resolve_device


def build_dataset(task, n_samples, train_size, test_size, n_classes, seed):
    """((points, labels, one-hot gt) of the train and the test split,
    n_classes): SyntheticCls (labels, its 8 classes) or SyntheticSeg (gt)."""
    if task == "classification":
        n_classes = SyntheticCls.NUM_CLASSES
        train = SyntheticCls(n_samples, length=train_size, seed=seed)
        test = SyntheticCls(n_samples, length=test_size, seed=seed + 7919)

        def stack(ds):
            pts, labels = zip(*[ds[i] for i in range(len(ds))])
            return np.stack(pts), np.asarray(labels, np.int64), None

        return stack(train), stack(test), n_classes
    train = SyntheticSeg(n_classes, n_samples, length=train_size, seed=seed)
    test = SyntheticSeg(n_classes, n_samples, length=test_size,
                        seed=seed + 7919)

    def stack(ds):
        pts, gts = zip(*[ds[i] for i in range(len(ds))])
        return np.stack(pts), None, np.stack(gts)

    return stack(train), stack(test), n_classes


def preprocess(points, gt_onehot, n_desired, n_classes, chunk=8,
               device="cuda"):
    """One NDT preprocessing of the whole split on ``device`` (the
    reference search), chunks of ``chunk`` clouds (the last padded with
    copies of its last cloud): the identical tensors both models consume,
    as numpy {"pcl", "covs", "gt", "mask"}."""
    dev = resolve_device(device)
    s = points.shape[0]
    outs = []
    for i in range(0, s, chunk):
        p = points[i:i + chunk]
        g = gt_onehot[i:i + chunk] if gt_onehot is not None else None
        pad = chunk - p.shape[0]
        if pad:
            p = np.concatenate([p, np.repeat(p[-1:], pad, axis=0)])
            if g is not None:
                g = np.concatenate([g, np.repeat(g[-1:], pad, axis=0)])
        pcl, covs, onehot, mask, _ = ndt_preprocessing_with_state(
            int(n_desired), torch.from_numpy(p).to(dev),
            torch.from_numpy(g).to(dev) if g is not None else None,
            int(n_classes),
        )
        outs.append(tuple(t.cpu().numpy() for t in (pcl, covs, onehot, mask)))
    cat = [np.concatenate(x)[:s] for x in zip(*outs)]
    return {"pcl": cat[0], "covs": cat[1], "gt": cat[2], "mask": cat[3]}


def make_models(task, n_classes, feature_dim, seed, device="cuda",
                dtype=torch.float32):
    """The reference model (torch seed ``seed``) and the port's model of
    the same task on ``device`` in ``dtype``, filled from it."""
    ref = reference_loader.load_reference_module("ndtnet")
    torch.manual_seed(seed)
    kw = dict(num_classes=n_classes, feature_dim=feature_dim, device=device,
              dtype=dtype, param_dtype=dtype)
    if task == "classification":
        t_model = ref.NDTNetClassification(3, n_classes, feature_dim)
        model = map_ndtnet_classification(t_model, NDTNetClassification(**kw))
    else:
        t_model = ref.NDTNetSegmentation(3, n_classes, feature_dim)
        model = map_ndtnet_segmentation(t_model, NDTNetSegmentation(**kw))
    return t_model, model


def train_torch(t_model, task, train_d, test_d, labels_tr, labels_te, perms,
                batch, lr, loss_mode, eval_every=0, wide_d=None,
                labels_wide=None, bn_frozen=False, f64=False):
    """Train the reference model on the preprocessed tensors; returns the
    per-epoch accuracy/loss curves + final test accuracy (train.py:84-87
    metric). eval_every=K also records test accuracy every K epochs
    (eval has no side effects — training math is unchanged). wide_d is an
    optional larger test split evaluated once at the end (batched so the
    narrow-metric math is untouched)."""
    if f64:
        t_model.double()
    opt = torch.optim.Adam(t_model.parameters(), lr=lr)
    dt = torch.float64 if f64 else torch.float32

    def tensors(d, idx):
        return (torch.tensor(d["pcl"][idx], dtype=dt),
                torch.tensor(d["covs"][idx], dtype=dt),
                torch.tensor(d["gt"][idx], dtype=dt),
                torch.tensor(d["mask"][idx], dtype=dt))

    def loss_and_acc(out, gt, mask, labels):
        if task == "classification":
            probs = out[:, :, 0]
            onehot = F.one_hot(labels, probs.shape[1]).to(dt)
            loss = -(onehot * torch.log(probs + 1e-9)).sum(1).mean()
            acc = (probs.argmax(1) == labels).float().mean()
        else:
            if loss_mode == "literal":
                # the reference's verbatim call (train.py:72): pred is
                # already log-probs and the class dim is wrong
                loss = F.cross_entropy(out, gt)
            else:
                ce = -(gt * out).sum(-1)
                loss = (ce * mask).sum() / mask.sum().clamp(min=1)
            hit = (out.argmax(-1) == gt.argmax(-1)).float()
            acc = (hit * mask).sum() / mask.sum().clamp(min=1)
        return loss, acc

    def eval_test(d=None, labels=None):
        d = test_d if d is None else d
        labels = labels_te if labels is None else labels
        t_model.eval()
        with torch.no_grad():
            idx = np.arange(d["pcl"].shape[0])
            pcl, covs, gt, mask = tensors(d, idx)
            lab = torch.tensor(labels) if labels is not None else None
            out = t_model(pcl, covs)
            _, test_acc = loss_and_acc(out, gt, mask, lab)
        return float(test_acc)

    def set_train_mode():
        t_model.train()
        if bn_frozen:
            # BN-frozen control: weights train, but normalization uses the
            # (initial) running stats and the stats never update — isolates
            # BN train-mode dynamics as a bifurcation source
            for mod in t_model.modules():
                if isinstance(mod, torch.nn.modules.batchnorm._BatchNorm):
                    mod.eval()

    curve, loss_curve, test_curve = [], [], []
    for ep, perm in enumerate(perms):
        set_train_mode()
        ep_acc, ep_loss = [], []
        for i in range(0, len(perm) - batch + 1, batch):
            idx = perm[i:i + batch]
            pcl, covs, gt, mask = tensors(train_d, idx)
            lab = (torch.tensor(labels_tr[idx])
                   if labels_tr is not None else None)
            out = t_model(pcl, covs)
            loss, acc = loss_and_acc(out, gt, mask, lab)
            opt.zero_grad()
            loss.backward()
            opt.step()
            ep_acc.append(float(acc))
            ep_loss.append(float(loss.detach()))
        curve.append(float(np.mean(ep_acc)))
        loss_curve.append(float(np.mean(ep_loss)))
        if eval_every and (ep + 1) % eval_every == 0:
            test_curve.append(eval_test())

    test_acc = eval_test()
    wide_acc = (eval_test(wide_d, labels_wide)
                if wide_d is not None else None)
    return curve, test_acc, loss_curve, test_curve, wide_acc


def train_port(model, task, train_d, test_d, labels_tr, labels_te, perms,
               batch, lr, n_classes, eval_every=0, wide_d=None,
               labels_wide=None, bn_frozen=False, loss_form="exact"):
    """Train the port's model (filled from the reference's init) on the
    same tensors in the same order, as the JAX tool's ``train_ndtpu``:
    ``torch.optim.Adam(lr, betas=(0.9, 0.999), eps=1e-8)`` at a constant
    rate, softmax cross-entropy from logits (masked for segmentation),
    BatchNorm in train mode (eval mode with ``bn_frozen``: the running
    statistics normalise and never update). The model's parameter type
    is the compute type. Returns the train accuracy and loss curves (a
    mean an epoch), the test accuracy, the test curve (every
    ``eval_every`` epochs), the wide split's accuracy and the final
    state_dict."""
    dev = next(model.parameters()).device
    dt = next(model.parameters()).dtype
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8)
    seg = task == "segmentation"

    def batch_of(d, labels, idx):
        pcl = torch.from_numpy(d["pcl"][idx]).to(dev)
        covs = torch.from_numpy(d["covs"][idx]).to(dev)
        if seg:
            target = torch.from_numpy(d["gt"][idx]).to(dev)
            mask = torch.from_numpy(d["mask"][idx]).to(dev)
        else:
            target = F.one_hot(torch.from_numpy(labels[idx]),
                               n_classes).to(dev, dt)
            mask = None
        return pcl, covs, target, mask

    def loss_of(logits, target, mask):
        if loss_form == "reference" and not seg:
            # the reference side's form (its train.py:72 with the softmax
            # head): cross-entropy on probabilities with a 1e-9 floor
            probs = torch.softmax(logits, dim=-1)
            return -(target * torch.log(probs + 1e-9)).sum(-1).mean()
        return cross_entropy_loss(logits, target, mask)

    def eval_test(d=None, labels=None):
        d = test_d if d is None else d
        labels = labels_te if labels is None else labels
        pcl, covs, target, mask = batch_of(d, labels,
                                           np.arange(d["pcl"].shape[0]))
        with torch.no_grad():
            logits = model.eval()(pcl, covs, return_logits=True)
            return float(accuracy(logits, target, mask))

    curve, loss_curve, test_curve = [], [], []
    for ep, perm in enumerate(perms):
        ep_acc, ep_loss = [], []
        for i in range(0, len(perm) - batch + 1, batch):
            pcl, covs, target, mask = batch_of(train_d, labels_tr,
                                               perm[i:i + batch])
            model.train(not bn_frozen)
            logits = model(pcl, covs, return_logits=True)
            loss = loss_of(logits, target, mask)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            ep_acc.append(float(accuracy(logits.detach(), target, mask)))
            ep_loss.append(float(loss.detach()))
        curve.append(float(np.mean(ep_acc)))
        loss_curve.append(float(np.mean(ep_loss)))
        if eval_every and (ep + 1) % eval_every == 0:
            test_curve.append(eval_test())

    wide_acc = (eval_test(wide_d, labels_wide)
                if wide_d is not None else None)
    finals = {k: v.detach().cpu().clone()
              for k, v in model.state_dict().items()}
    return curve, eval_test(), loss_curve, test_curve, wide_acc, finals


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--task", default="classification",
                    choices=["classification", "segmentation"])
    ap.add_argument("--n_desired_nds", type=int, default=1000)
    ap.add_argument("--n_samples", type=int, default=4096)
    ap.add_argument("--n_classes", type=int, default=8)
    ap.add_argument("--feature_dim", type=int, default=128)
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--train_size", type=int, default=64)
    ap.add_argument("--test_size", type=int, default=16)
    ap.add_argument("--wide_test_size", type=int, default=0,
                    help="also evaluate both final models on this many test "
                         "clouds (>= test_size; the first test_size clouds "
                         "are the narrow split's, each cloud being drawn "
                         "from (seed, index))")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--torch_loss", default="intent",
                    choices=["intent", "literal"])
    ap.add_argument("--ndtpu_loss", default="exact",
                    choices=["exact", "reference"],
                    help="classification loss of the port side: 'exact' "
                         "cross-entropy from logits, 'reference' the "
                         "reference side's -(onehot * log(softmax + 1e-9)) "
                         "(the same math, another rounding)")
    ap.add_argument("--save_finals", default="",
                    help="path prefix: save both final models' weights "
                         "({prefix}_ndtpu_torch.pt, {prefix}_torch.pt)")
    ap.add_argument("--eval_every", type=int, default=0,
                    help="also record test accuracy every K epochs")
    ap.add_argument("--perturb_init", type=float, default=0.0,
                    help="add N(0, scale) noise to one side's copy of the "
                         "shared init (the basin-sensitivity control)")
    ap.add_argument("--perturb_side", default="ndtpu_torch",
                    choices=["ndtpu_torch", "torch"],
                    help="which side's weights receive the --perturb_init "
                         "noise")
    ap.add_argument("--bn_frozen", action="store_true",
                    help="train both sides with BatchNorm normalising by the "
                         "initial running statistics, never updated")
    ap.add_argument("--precision", default="f32", choices=["f32", "f64"],
                    help="f64: train both sides in float64")
    ap.add_argument("--out", default="")
    ap.add_argument("--device", type=str, default="cuda",
                    help="the port side's device: cuda (default) or cpu")
    return ap.parse_args(argv)


def perturb_(model, scale, seed=999):
    """Add N(0, scale) noise to every parameter of ``model`` in place, drawn
    on the CPU from a ``torch.Generator`` seeded ``seed``."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            noise = torch.randn(p.shape, generator=g, dtype=p.dtype)
            p.add_(scale * noise.to(p.device))


def main(argv=None):
    """Run the experiment as the flags say. Returns the result dict."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    t0 = time.time()
    full_test = max(args.test_size, args.wide_test_size)
    (tr_pts, tr_lab, tr_gt), (te_pts, te_lab, te_gt), n_classes = (
        build_dataset(args.task, args.n_samples, args.train_size,
                      full_test, args.n_classes, args.seed)
    )
    print(f"[parity] dataset built ({time.time() - t0:.1f}s); "
          f"preprocessing {args.train_size}+{full_test} clouds "
          f"of {args.n_samples} pts -> {args.n_desired_nds} NDs ...",
          flush=True)
    train_d = preprocess(tr_pts, tr_gt, args.n_desired_nds, n_classes,
                         chunk=args.batch_size, device=dev)
    wide_full = preprocess(te_pts, te_gt, args.n_desired_nds, n_classes,
                           chunk=args.batch_size, device=dev)
    # the narrow split is a prefix of the wide one: preprocessing is chunked
    # at batch_size, so its rows are those of a narrow-only run
    test_d = {k: v[:args.test_size] for k, v in wide_full.items()}
    wide_d = wide_full if args.wide_test_size > args.test_size else None
    te_lab_wide = te_lab
    if te_lab is not None:
        te_lab, te_lab_wide = te_lab[:args.test_size], te_lab
    print(f"[parity] preprocessing done ({time.time() - t0:.1f}s); "
          f"mask valid fraction train="
          f"{train_d['mask'].mean():.4f} test={test_d['mask'].mean():.4f}",
          flush=True)

    f64 = args.precision == "f64"
    t_model, model = make_models(
        args.task, n_classes, args.feature_dim, args.seed, dev,
        torch.float64 if f64 else torch.float32)
    if args.perturb_init:
        perturb_(model if args.perturb_side == "ndtpu_torch" else t_model,
                 args.perturb_init)
    rng = np.random.default_rng(args.seed + 13)
    perms = [rng.permutation(args.train_size) for _ in range(args.epochs)]

    p_curve, p_test, p_loss, p_testc, p_wide, p_finals = train_port(
        model, args.task, train_d, test_d, tr_lab, te_lab, perms,
        args.batch_size, args.lr, n_classes, args.eval_every, wide_d,
        te_lab_wide, args.bn_frozen, args.ndtpu_loss,
    )
    print(f"[parity] ndtpu_torch trained ({time.time() - t0:.1f}s): "
          f"final train acc {p_curve[-1]:.4f}, test acc {p_test:.4f}"
          + (f", wide acc {p_wide:.4f}" if p_wide is not None else ""),
          flush=True)
    t_curve, t_test, t_loss, t_testc, t_wide = train_torch(
        t_model, args.task, train_d, test_d, tr_lab, te_lab, perms,
        args.batch_size, args.lr, args.torch_loss, args.eval_every,
        wide_d, te_lab_wide, args.bn_frozen, f64,
    )
    print(f"[parity] torch reference trained ({time.time() - t0:.1f}s): "
          f"final train acc {t_curve[-1]:.4f}, test acc {t_test:.4f}"
          + (f", wide acc {t_wide:.4f}" if t_wide is not None else ""),
          flush=True)

    result = {
        "task": args.task,
        "n_desired_nds": args.n_desired_nds,
        "n_samples": args.n_samples,
        "n_classes": n_classes,
        "feature_dim": args.feature_dim,
        "epochs": args.epochs,
        "batch_size": args.batch_size,
        "lr": args.lr,
        "torch_loss": args.torch_loss,
        "ndtpu_torch": {"train_curve": p_curve, "test_accuracy": p_test,
                        "train_loss_curve": p_loss, "test_curve": p_testc,
                        "test_accuracy_wide": p_wide},
        "torch_reference": {"train_curve": t_curve, "test_accuracy": t_test,
                            "train_loss_curve": t_loss, "test_curve": t_testc,
                            "test_accuracy_wide": t_wide},
        "wide_test_size": args.wide_test_size,
        "bn_frozen": args.bn_frozen,
        "precision": args.precision,
        "ndtpu_loss": args.ndtpu_loss,
        "parity": p_test >= t_test - 0.02,
        "wall_s": round(time.time() - t0, 1),
    }
    if args.save_finals:
        torch.save(p_finals, args.save_finals + "_ndtpu_torch.pt")
        torch.save(t_model.state_dict(), args.save_finals + "_torch.pt")
        result["finals"] = args.save_finals
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
            f.write("\n")
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
