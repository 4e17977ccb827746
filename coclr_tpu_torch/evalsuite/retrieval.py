"""Feature extraction and nearest-neighbour retrieval, ported from
coclr_tpu/evalsuite/retrieval.py (the reference's eval/main_classifier.py
retrieval path).

Every (video, window) clip is flattened into one stream and run in
fixed-size batches; a video's feature is the mean over its windows,
accumulated on the device. Clips go through the eval jitter (ColorJitter
(0.2, 0.2, 0.2, 0.1) at p 0.3 per clip, one launch of the jitter kernel)
as the reference extracts them. The cache keeps the reference's names and
formats ({dataset}_{split}_{feature,label}.pth.tar as torch tensors and a
vname pickle), so the files of either package load in the other. The
similarity and its top-k run on the model's device.
"""

from __future__ import annotations

import os
import pickle
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, List, Tuple

import numpy as np
import torch

from coclr_tpu_torch.ops.augment import apply_eval_jitter, draw_eval_jitter_params
from coclr_tpu_torch.parallel.train_step import to_ncdhw

EXTRACT_JITTER = dict(p=0.3, strength=(0.2, 0.2, 0.2, 0.1))
KS = (1, 5, 10, 20, 50)
CLIP_BATCH = 32  # clips per forward in extraction and the N-crop test


def iter_flat_window_batches(dataset, clip_batch: int, num_workers: int = 8
                             ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield (clips [clip_batch, T, S, S, 3], video_ids [clip_batch]). The
    final batch is padded with repeats of its last clip (video_id -1)."""
    buf_clips: List[np.ndarray] = []
    buf_vids: List[int] = []

    def flush(force=False):
        while len(buf_clips) >= clip_batch or (force and buf_clips):
            take = buf_clips[:clip_batch]
            vids = buf_vids[:clip_batch]
            del buf_clips[:clip_batch], buf_vids[:clip_batch]
            if len(take) < clip_batch:
                pad = clip_batch - len(take)
                take = take + [take[-1]] * pad
                vids = vids + [-1] * pad
            yield np.stack(take), np.asarray(vids, np.int64)

    with ThreadPoolExecutor(max_workers=max(1, num_workers)) as ex:
        for sample in ex.map(dataset.__getitem__, range(len(dataset))):
            vid = int(sample["index"])
            for clip in sample["seq"]:
                buf_clips.append(clip)
                buf_vids.append(vid)
            yield from flush()
        yield from flush(force=True)


def video_means(fn: Callable, dataset, clip_batch: int, num_workers: int,
                device) -> Tuple[np.ndarray, np.ndarray]:
    """Per-video means of fn(uint8 clips on `device`) -> [clip_batch, d]
    float32 over each video's windows. Returns (means [N, d], window
    counts [N]); the sums stay on the device until the end."""
    sums = counts = None
    for clips, vids in iter_flat_window_batches(dataset, clip_batch,
                                                num_workers):
        x = torch.from_numpy(clips)
        v = torch.from_numpy(vids)
        if device.type == "cuda":
            x = x.pin_memory().to(device, non_blocking=True)
            v = v.pin_memory().to(device, non_blocking=True)
        out = fn(x).to(torch.float32)
        if sums is None:
            sums = torch.zeros(len(dataset), out.shape[1], device=device)
            counts = torch.zeros(len(dataset), device=device)
        valid = (v >= 0).to(torch.float32)
        idx = v.clamp_min(0)
        sums.index_add_(0, idx, out * valid[:, None])
        counts.index_add_(0, idx, valid)
    counts = counts.cpu()
    means = sums.cpu() / torch.clamp_min(counts, 1.0)[:, None]
    return means.numpy(), counts.numpy().astype(np.int64)


def extract_features(model, dataset, cfg, clip_batch: int = CLIP_BATCH
                     ) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    """Mean-pooled backbone features per video (mean over windows) through
    the eval jitter, in cfg.dtype. Returns (features [N, fs], labels [N],
    vnames [N])."""
    device = next(model.parameters()).device
    gen = torch.Generator(device).manual_seed(0)
    model.eval()

    @torch.no_grad()
    def feat_fn(clips):
        params = draw_eval_jitter_params(gen, clips.shape[0], **EXTRACT_JITTER)
        x = apply_eval_jitter(clips, params, cfg.dtype)
        return model(to_ncdhw(x))[1]

    features, _ = video_means(feat_fn, dataset, clip_batch, cfg.workers,
                              device)
    labels = np.zeros((len(dataset),), np.int64)
    vnames = []
    for i in range(len(dataset)):
        row = dataset.video_subset.iloc[i]
        labels[i] = dataset.encode_action(row[2])
        vnames.append(row[3])
    return features, labels, vnames


def _paths(dirpath: str, dataset_name: str, split: str):
    stem = os.path.join(dirpath, f"{dataset_name}_{split}_")
    return stem + "feature.pth.tar", stem + "label.pth.tar", stem + "vname.pkl"


def save_feature_cache(dirpath: str, dataset_name: str, split: str,
                       features, labels, vnames) -> None:
    """The reference's cache: torch tensors and a pickle of [[vname], ...]."""
    os.makedirs(dirpath, exist_ok=True)
    fpath, lpath, vpath = _paths(dirpath, dataset_name, split)
    torch.save(torch.from_numpy(np.ascontiguousarray(features)), fpath)
    torch.save(torch.from_numpy(np.ascontiguousarray(labels)), lpath)
    with open(vpath, "wb") as fp:
        pickle.dump([[v] for v in vnames], fp)


def load_feature_cache(dirpath: str, dataset_name: str, split: str):
    """Inverse of save_feature_cache: (features, labels, vnames as written)."""
    fpath, lpath, vpath = _paths(dirpath, dataset_name, split)
    f = torch.load(fpath, map_location="cpu", weights_only=True).numpy()
    l = torch.load(lpath, map_location="cpu", weights_only=True).numpy()
    with open(vpath, "rb") as fp:
        vnames = pickle.load(fp)
    return f, l, vnames


def center_normalize(x: np.ndarray) -> np.ndarray:
    """Centering, then L2 normalize (eval/main_classifier.py:690-695)."""
    x = x - x.mean(axis=0, keepdims=True)
    return x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)


def nn_retrieval(test_feature, test_label, train_feature, train_label,
                 ks=KS, device="cpu") -> Dict[int, float]:
    """Recall@k of cosine nearest neighbours: the share of test videos with
    a train video of their class among their k nearest. The similarity and
    its top-k run on `device`."""
    tf, rf = (torch.from_numpy(center_normalize(np.asarray(f, np.float32)))
              .to(device) for f in (test_feature, train_feature))
    sim = tf @ rf.t()
    maxk = min(max(ks), sim.shape[1])
    top = sim.topk(maxk, dim=1).indices.cpu().numpy()
    hits = np.asarray(train_label)[top] == np.asarray(test_label)[:, None]
    return {k: float(np.any(hits[:, :min(k, maxk)], axis=1).mean())
            for k in ks}


def run_retrieval(model, cfg, train_dataset, test_dataset, cache_dir: str,
                  clip_batch: int = CLIP_BATCH) -> Dict[int, float]:
    """Retrieval with the feature cache: each split's features are read
    from `cache_dir` where present, else extracted and written there."""
    name = cfg.dataset
    feats = {}
    for split, ds in (("test", test_dataset), ("train", train_dataset)):
        if os.path.exists(_paths(cache_dir, name, split)[0]):
            feats[split] = load_feature_cache(cache_dir, name, split)
        else:
            feats[split] = extract_features(model, ds, cfg, clip_batch)
            save_feature_cache(cache_dir, name, split, *feats[split])
    results = nn_retrieval(feats["test"][0], feats["test"][1],
                           feats["train"][0], feats["train"][1],
                           device=next(model.parameters()).device)
    for k, acc in results.items():
        print("%dNN acc = %.4f" % (k, acc))
    return results
