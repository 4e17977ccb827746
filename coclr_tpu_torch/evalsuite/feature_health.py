"""Health of a retrieval's features: whether they are finite, how much they
spread, how many directions they use, and whether one train video sits
nearest to most queries (a hub).

    python -m coclr_tpu_torch.evalsuite.feature_health <cache dir> [...]

prints one JSON line per feature cache (the `--retrieval --dirname` files,
evalsuite/retrieval.py) found in each directory. The numbers:

- `nonfinite`: the count of non-finite values over both splits. Retrieval
  centers each split on its mean, so one non-finite row makes every
  similarity NaN and its R@k means nothing; the other numbers are then
  None and `finite` is False.
- `std_min`, `std_median`: the per-dimension standard deviation of the
  features after centering each split on its own mean (as retrieval
  does), over both splits, the least and the median dimension.
- `effective_rank`: exp of the entropy of the centered features' singular
  values, each divided by their sum: the number of directions the
  features spread over (0 for constant features).
- `hub_share`: the largest fraction of the test queries that share one
  top-1 train video under retrieval's centered cosine similarity, and
  `hub_index`, that train video's row.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List

import numpy as np

from coclr_tpu_torch.evalsuite.retrieval import (center_normalize,
                                                 load_feature_cache)

_SUFFIX = "_test_feature.pth.tar"


def feature_health(train_feature, test_feature) -> Dict:
    """The health numbers of the module docstring for one retrieval's train
    and test features ([N, d] each)."""
    train = np.asarray(train_feature, np.float32)
    test = np.asarray(test_feature, np.float32)
    nonfinite = int(np.size(train) - np.isfinite(train).sum()
                    + np.size(test) - np.isfinite(test).sum())
    out = {"n_train": int(train.shape[0]), "n_test": int(test.shape[0]),
           "dim": int(train.shape[1]), "nonfinite": nonfinite,
           "finite": nonfinite == 0}
    if nonfinite:
        out.update(std_min=None, std_median=None, effective_rank=None,
                   hub_share=None, hub_index=None)
        return out
    centered = np.concatenate([x - x.mean(axis=0, keepdims=True)
                               for x in (train.astype(np.float64),
                                         test.astype(np.float64))])
    std = centered.std(axis=0)
    sv = np.linalg.svd(centered, compute_uv=False)
    if sv.sum() > 0:
        p = sv / sv.sum()
        p = p[p > 0]
        erank = float(np.exp(-np.sum(p * np.log(p))))
    else:
        erank = 0.0
    sim = center_normalize(test) @ center_normalize(train).T
    top1 = np.argmax(sim, axis=1)
    counts = np.bincount(top1, minlength=train.shape[0])
    out.update(std_min=float(std.min()), std_median=float(np.median(std)),
               effective_rank=erank,
               hub_share=float(counts.max() / test.shape[0]),
               hub_index=int(counts.argmax()))
    return out


def cache_health(dirpath: str) -> List[Dict]:
    """feature_health of every feature cache in `dirpath` (one per dataset
    name with both splits), each with its `dataset`; [] if there is
    none."""
    out = []
    for path in sorted(glob.glob(os.path.join(dirpath, "*" + _SUFFIX))):
        name = os.path.basename(path)[:-len(_SUFFIX)]
        if not os.path.exists(os.path.join(dirpath,
                                           f"{name}_train_feature.pth.tar")):
            continue
        test = load_feature_cache(dirpath, name, "test")[0]
        train = load_feature_cache(dirpath, name, "train")[0]
        out.append({"dataset": name, **feature_health(train, test)})
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dirs", nargs="+",
                    help="directories holding --retrieval feature caches")
    args = ap.parse_args(argv)
    for d in args.dirs:
        for h in cache_health(d):
            print(json.dumps({"dir": d, **h}), flush=True)


if __name__ == "__main__":
    main()
