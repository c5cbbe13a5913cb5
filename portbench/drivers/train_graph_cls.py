"""The classification trainer with ``--device_cache`` and the epoch scan:
``train_graph``'s whole shuffled epochs of ``make_epoch_scan``'s CUDA
graph over the split resident on the card, with one label a cloud in
place of the per-point tags.

At set-up the program's untagged preprocessing runs over the split
(the configuration's ``train_split``, which the traffic's ``split``
must equal), a batch at a time, and each cloud's label is its family's
``labels`` of the occupied voxel count it found (``families/ndtnet_cls40.py``): the
[split, C] float32 one-hots are the step's second array. The check
batches go to the judge untagged, as the classification step
preprocesses them."""
from __future__ import annotations

from pathlib import Path

import torch

from portbench import program, spec

train_graph = spec.found("drivers", "train_graph", Path(__file__).resolve().parents[2])


class Driver(train_graph.Driver):
    def setup(self):
        if self.split != self.cfg["train_split"]:
            raise ValueError(f"traffic split {self.split} is not the configuration's "
                             f"train_split {self.cfg['train_split']}")
        (nds,) = self.family.resolutions(self.cfg)
        valid = [program.preprocess(self.cfg, nds, self.points[s:s + self.batch])
                 ["state"]["num_valid"] for s in range(0, self.split, self.batch)]
        # train_graph hands the scan (points, tags): the labels take the
        # tags' place
        self.tags = self.family.labels(torch.cat(valid), self.cfg["n_classes"])
        super().setup()

    def evidence(self):
        ev = super().evidence()
        ev["batches"] = [(pts, None, sizes) for pts, _, sizes in ev["batches"]]
        return ev
