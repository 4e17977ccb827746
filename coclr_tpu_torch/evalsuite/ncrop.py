"""Center / five / ten-crop test, ported from coclr_tpu/evalsuite/ncrop.py
(the reference's eval/main_classifier.py test_10crop).

For each (crop position, flip) configuration, every temporal window of
every test video is classified; a video's softmax is the mean over its
windows, accumulated on the device, and the means of the configurations
are summarized at the center, five and ten checkpoints. The per-video
probabilities go to `{ckpt}-prob-{title}.json` in the reference's format,
for merge_2stream_prob. The host crops and flips; the per-clip
ColorJitter(0.2, 0.2, 0.2, 0.1) at p 0.3 and the normalize run in one
launch of the jitter kernel per batch.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np
import torch

from coclr_tpu_torch.data import hostaug
from coclr_tpu_torch.evalsuite.retrieval import (CLIP_BATCH, EXTRACT_JITTER,
                                                 video_means)
from coclr_tpu_torch.ops.augment import apply_eval_jitter, draw_eval_jitter_params
from coclr_tpu_torch.parallel.train_step import to_ncdhw
from coclr_tpu_torch.utils.meters import AverageMeter


class NCropPolicy(hostaug.EvalClipPolicy):
    """FiveCrop(224) at `where`, then flip and Scale(img_dim) on the host."""

    def __init__(self, img_dim: int, where: int, flip: bool):
        super().__init__(img_dim=img_dim, mode="test", crop_where=where)
        self.flip = flip

    def post(self, clip):
        if self.flip:
            clip = np.ascontiguousarray(clip[:, :, ::-1, :])
        return clip


def run_ncrop_test(model, cfg, make_dataset, out_dir: str, ckpt_name: str,
                   clip_batch: int = CLIP_BATCH):
    """make_dataset(policy) -> a test-mode dataset. cfg.center_crop /
    five_crop / ten_crop choose the configurations. Returns {title:
    (top1, top5)} for each checkpoint summarized."""
    if cfg.center_crop:
        aug_list, flip_list, title = [5], [0], "center"
    elif cfg.five_crop:
        aug_list, flip_list, title = [5, 1, 2, 3, 4], [0], "five"
    else:
        aug_list, flip_list, title = [5, 1, 2, 3, 4], [0, 1], "ten"

    device = next(model.parameters()).device
    gen = torch.Generator(device).manual_seed(0)
    model.eval()

    @torch.no_grad()
    def prob_fn(clips):
        params = draw_eval_jitter_params(gen, clips.shape[0], **EXTRACT_JITTER)
        x = apply_eval_jitter(clips, params, cfg.dtype)
        return torch.softmax(model(to_ncdhw(x))[0], dim=-1)

    prob_dict: Dict[str, list] = {}
    results = {}
    for flip_idx in flip_list:
        for aug_idx in aug_list:
            print(f"Aug type: {aug_idx}; flip: {flip_idx}")
            dataset = make_dataset(NCropPolicy(cfg.img_dim, aug_idx,
                                               bool(flip_idx)))
            means, counts = video_means(prob_fn, dataset, clip_batch,
                                        cfg.workers, device)
            for v in np.nonzero(counts)[0]:
                vname = dataset.video_subset.iloc[int(v)][3]
                prob_dict.setdefault(vname, []).append(means[v])
            if title == "ten" and flip_idx == 0 and aug_idx == 5:
                results["center"] = summarize_probability(
                    prob_dict, dataset.encode_action, "center", out_dir,
                    ckpt_name)
        if title == "ten" and flip_idx == 0:
            results["five"] = summarize_probability(
                prob_dict, dataset.encode_action, "five", out_dir, ckpt_name)
    results[title] = summarize_probability(prob_dict, dataset.encode_action,
                                           title, out_dir, ckpt_name)
    return results


def summarize_probability(prob_dict, action_to_idx, title: str,
                          out_dir: str, ckpt_name: str):
    """Per-video mean probability -> (top1, top5), and the prob json
    (eval/main_classifier.py:524-545)."""
    acc = [AverageMeter(), AverageMeter()]
    stat = {}
    for vname, probs in prob_dict.items():
        # 'Class/video' has no [-3]: the reference then takes [-2]
        try:
            action_name = vname.split("/")[-3]
        except IndexError:
            action_name = vname.split("/")[-2]
        target = action_to_idx(action_name)
        mean_prob = np.mean(np.stack(probs, 0), axis=0)
        top = np.argsort(-mean_prob)
        acc[0].update(float(top[0] == target), 1)
        acc[1].update(float(target in top[:5]), 1)
        stat[vname] = {"mean_prob": mean_prob.tolist()}
    print("Mean: Acc@1: {0:.4f} Acc@5: {1:.4f}".format(acc[0].avg, acc[1].avg))
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{ckpt_name}-prob-{title}.json"),
              "w") as fp:
        json.dump(stat, fp)
    return acc[0].avg, acc[1].avg
