"""Dataset cloud-size histogram (port of ``tools/point_histogram.py``).

    python -m ndtpu_torch.tools.point_histogram --path <dir of .ply> \\
        [--out out/point_histogram.png]

The reference's tools/point_histogram.py:19-43, headless: each cloud's
vertex count is read from its PLY header (``count_ply_points``), the
counts' summary is printed, and the histogram is saved as a PNG with
matplotlib, imported only to draw it. The tool runs on the host only.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from ndtpu_torch.data.ply import count_ply_points


def main(argv=None):
    """Print the summary line and write the PNG. Returns the counts."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--path", type=str, required=True)
    p.add_argument("--out", type=str, default="out/point_histogram.png")
    p.add_argument("--bins", type=int, default=50)
    args = p.parse_args(argv)

    counts = np.asarray([count_ply_points(os.path.join(args.path, name))
                         for name in sorted(os.listdir(args.path))
                         if name.endswith(".ply")])
    if counts.size == 0:
        print("no .ply files found")
        return counts
    print(f"{counts.size} files; min={counts.min()} max={counts.max()} "
          f"mean={counts.mean():.1f} median={np.median(counts):.0f}")

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.hist(counts, bins=args.bins)
    plt.xlabel("points per cloud")
    plt.ylabel("files")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    plt.savefig(args.out, dpi=120)
    print(f"wrote {args.out}")
    return counts


if __name__ == "__main__":
    main(sys.argv[1:])
