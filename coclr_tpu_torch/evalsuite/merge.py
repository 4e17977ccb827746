"""Two-stream fusion, ported from coclr_tpu/evalsuite/merge.py (the
reference's eval/merge_2stream_prob.py). Host numpy over the files the
other eval paths write.

mode 'c' (merge_prob): average two per-video probability jsons and take
    the merged top-1;
mode 's' (merge_sim): align the RGB and flow feature caches by vname, sum
    their cosine similarity matrices, and take the merged recall@k.
"""

from __future__ import annotations

import json
from typing import Dict, List, Sequence

import numpy as np

from coclr_tpu_torch.evalsuite.retrieval import (KS, center_normalize,
                                                 load_feature_cache)
from coclr_tpu_torch.utils.meters import AverageMeter


def _mean_prob(entry):
    return np.asarray(entry["mean_prob"] if isinstance(entry, dict) else entry)


def merge_prob(prob_path1: str, prob_path2: str, action_list: Sequence[str],
               k400_style: bool = False):
    """Returns (acc1, acc2, merged_acc) (merge_2stream_prob.py:60-101)."""
    with open(prob_path1) as fp:
        prob_dict1 = json.load(fp)
    with open(prob_path2) as fp:
        prob_dict2 = json.load(fp)
    action_to_idx = {a: i for i, a in enumerate(action_list)}

    meters = [AverageMeter(), AverageMeter(), AverageMeter()]
    for k in prob_dict1:
        p1, p2 = _mean_prob(prob_dict1[k]), _mean_prob(prob_dict2[k])
        if k400_style:
            label = action_to_idx[k.split("/")[-2]]
        else:
            try:
                label = action_to_idx[k.split("/")[-3]]
            except (IndexError, KeyError):
                label = action_to_idx[k.split("/")[-2]]
        p = (p1 + p2) / 2
        meters[0].update(float(np.argmax(p1, axis=-1) == label))
        meters[1].update(float(np.argmax(p2, axis=-1) == label))
        meters[2].update(float(np.argmax(p, axis=-1) == label))
    print("merged accuracy: %.6f + %.6f => %.6f"
          % (meters[0].avg, meters[1].avg, meters[2].avg))
    return meters[0].avg, meters[1].avg, meters[2].avg


def _sort_align(vnames: List, feats: np.ndarray, labels=None):
    vn = np.squeeze(np.asarray(vnames))
    order = np.argsort(vn)
    out = [vn[order], feats[order]]
    if labels is not None:
        out.append(labels[order])
    return out


def merge_sim(dir1: str, dir2: str, dataset: str, ks=KS) -> Dict[int, float]:
    """dir1 holds the '{dataset}_*' caches (RGB), dir2 the '{dataset}-f_*'
    caches (flow); merge_2stream_prob.py:104-198."""
    f1_tr, l_tr, v1_tr = load_feature_cache(dir1, dataset, "train")
    f1_te, l_te, v1_te = load_feature_cache(dir1, dataset, "test")
    f2_tr, _, v2_tr = load_feature_cache(dir2, dataset + "-f", "train")
    f2_te, _, v2_te = load_feature_cache(dir2, dataset + "-f", "test")

    v1_tr, f1_tr, l_tr = _sort_align(v1_tr, f1_tr, l_tr)
    v1_te, f1_te, l_te = _sort_align(v1_te, f1_te, l_te)
    v2_tr, f2_tr = _sort_align(v2_tr, f2_tr)
    v2_te, f2_te = _sort_align(v2_te, f2_te)

    # keep the videos both streams have (flow sets can be smaller)
    if len(v1_tr) < len(v2_tr):
        keep = np.isin(v2_tr, v1_tr)
        v2_tr, f2_tr = v2_tr[keep], f2_tr[keep]
        keep = np.isin(v2_te, v1_te)
        v2_te, f2_te = v2_te[keep], f2_te[keep]
    if len(v1_tr) > len(v2_tr):
        keep = np.isin(v1_tr, v2_tr)
        v1_tr, f1_tr, l_tr = v1_tr[keep], f1_tr[keep], l_tr[keep]
        keep = np.isin(v1_te, v2_te)
        v1_te, f1_te, l_te = v1_te[keep], f1_te[keep], l_te[keep]
    if not (np.array_equal(v1_tr, v2_tr) and np.array_equal(v1_te, v2_te)):
        raise ValueError("the two streams' caches hold different videos")

    sim = (center_normalize(f1_te) @ center_normalize(f1_tr).T
           + center_normalize(f2_te) @ center_normalize(f2_tr).T)
    out = {}
    maxk = min(max(ks), sim.shape[1])
    top = np.argsort(-sim, axis=1)[:, :maxk]
    hits = l_tr[top] == l_te[:, None]
    for k in ks:
        out[k] = float(np.any(hits[:, :min(k, maxk)], axis=1).mean())
        print("%dNN acc = %.4f" % (k, out[k]))
    return out
