"""Merge a ZeRO checkpoint's rank files into one fp32 state dict.

Port of ``deepspeed_tpu/checkpoint/zero_to_fp32.py`` (reference
``utils/zero_to_fp32.py``): each ``zero_pp_rank_<r>_mp_rank_00_optim_states.pt``
holds that rank's chunk of every master (whole where the plan does not
shard the leaf); the chunks of one replica's ZeRO group, in ZeRO-rank
order, concatenate along the leaf's sharded dimension. Under expert
parallelism each expert rank's group holds its E / ep experts of an expert
leaf, and those join along the leaf's expert dimension; under tensor
parallelism each tensor rank's group holds its slice of a split leaf, and
those join along the leaf's tensor dimension, so the output holds whole
leaves.

CLI:  python -m deepspeed_tpu_torch.checkpoint.zero_to_fp32 <ckpt_dir> <out_file> [-t TAG]

The output file is a ``torch.save`` of ``{"a/b/kernel": fp32 tensor}``.
"""

import argparse
import glob
import logging
import os
from typing import Any, Dict, Optional

import torch

from .universal import _resolve_tag
from .utils import unflatten_tree

logger = logging.getLogger(__name__)


def get_fp32_flat_state_dict_from_zero_checkpoint(checkpoint_dir: str, tag: Optional[str] = None) -> Dict[str, Any]:
    """``{path: fp32 tensor}`` merged from the rank files of ``<checkpoint_dir>/<tag>``."""
    d = os.path.join(checkpoint_dir, _resolve_tag(checkpoint_dir, tag))
    files = sorted(glob.glob(os.path.join(d, "zero_pp_rank_*_mp_rank_00_optim_states.pt")))
    if not files:
        raise FileNotFoundError(f"no zero_pp_rank_*_mp_rank_00_optim_states.pt files in {d}")
    ranks = [torch.load(f, map_location="cpu", weights_only=False) for f in files]
    ep, tp = ranks[0].get("ep_size", 1), ranks[0].get("tp_size", 1)
    size = ranks[0]["zero_size"]
    groups = {}
    for e in range(ep):
        for t in range(tp):
            group = sorted((s for s in ranks if s["replica_rank"] == 0 and s.get("ep_rank", 0) == e
                            and s.get("tp_rank", 0) == t), key=lambda s: s["zero_rank"])
            if [s["zero_rank"] for s in group] != list(range(size)):
                raise ValueError(f"{d}: the rank files of expert rank {e}, tensor rank {t} hold ZeRO ranks "
                                 f"{[s['zero_rank'] for s in group]}, expected 0..{size - 1}")
            groups[(e, t)] = group
    n = len(ranks[0]["leaves"])
    expert_dims = ranks[0].get("expert_dims") or [None] * n
    tensor_dims = ranks[0].get("tensor_dims") or [None] * n
    out = {}
    for (path, shape, dim), edim, tdim in zip(groups[(0, 0)][0]["leaves"], expert_dims, tensor_dims):
        def local(g):
            return g[0]["fp32"][path] if dim is None else torch.cat([s["fp32"][path] for s in g], dim=dim)

        per_expert = []
        for e in range(ep):
            slices = [local(groups[(e, t)]) for t in range(tp)]
            per_expert.append(slices[0] if tdim is None else torch.cat(slices, dim=tdim))
        t = per_expert[0] if edim is None else torch.cat(per_expert, dim=edim)
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{path}: merged shape {tuple(t.shape)}, expected {tuple(shape)}")
        out[path] = t.float()
    return out


def get_fp32_state_dict_from_zero_checkpoint(checkpoint_dir: str, tag: Optional[str] = None) -> Dict[str, Any]:
    """The merged fp32 masters as a nested dict of tensors."""
    return unflatten_tree(get_fp32_flat_state_dict_from_zero_checkpoint(checkpoint_dir, tag))


def convert_zero_checkpoint_to_fp32_state_dict(checkpoint_dir: str, output_file: str,
                                               tag: Optional[str] = None) -> str:
    sd = get_fp32_flat_state_dict_from_zero_checkpoint(checkpoint_dir, tag)
    os.makedirs(os.path.dirname(os.path.abspath(output_file)), exist_ok=True)
    torch.save(sd, output_file)
    logger.info(f"fp32 state dict with {len(sd)} tensors written to {output_file}")
    return output_file


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("checkpoint_dir", help="engine checkpoint directory (contains 'latest')")
    parser.add_argument("output_file", help="path for the fp32 state dict (torch.save)")
    parser.add_argument("-t", "--tag", default=None, help="checkpoint tag (default: read 'latest')")
    args = parser.parse_args(argv)
    convert_zero_checkpoint_to_fp32_state_dict(args.checkpoint_dir, args.output_file, args.tag)


if __name__ == "__main__":
    main()
