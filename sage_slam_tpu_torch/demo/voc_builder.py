"""Offline BoW vocabulary training CLI (port of
sage_slam_tpu/demo/voc_builder.py, the reference's voc_builder).

Collects feature-net descriptors at random pixels over a dataset (500 per
frame, k=10, L=3 as the reference's bow_voc flags) and trains the
hierarchical k-means vocabulary; saves it as npz in the JAX package's
layout. ``load_npz_vocabulary`` reads such a file (either package's).

The flags are the JAX CLI's plus ``--device`` (default: the current CUDA
device). The feature network is randomly initialised from
``torch.Generator().manual_seed(0)`` unless a checkpoint is given.
"""

from __future__ import annotations

import argparse

import numpy as np

from ..loop.vocabulary import load_npz_vocabulary  # noqa: F401 - this module's reader


def main(argv=None):
    import faulthandler

    faulthandler.enable()

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--source_url", default="synthetic://")
    p.add_argument("--output", default="bow_voc.npz")
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--levels", type=int, default=3)
    p.add_argument("--points_per_frame", type=int, default=500)
    p.add_argument("--max_frames", type=int, default=100)
    p.add_argument("--feat_checkpoint", default=None)
    p.add_argument("--input_size", default="128,160",
                   help="synthetic source image size H,W (must divide 32)")
    p.add_argument("--device", default=None, help="torch device (default: the current CUDA device)")
    args = p.parse_args(argv)

    import torch

    from ..device import resolve_device
    from ..io import dataset
    from ..loop import vocabulary
    from ..models import feature_network

    dev = resolve_device(args.device)
    if args.source_url.startswith("synthetic://"):
        h, w = (int(x) for x in args.input_size.split(","))
        data = dataset.SyntheticInterface(num_frames=args.max_frames, height=h, width=w)
    else:
        data = dataset.from_url(args.source_url)
    feat_cfg = feature_network.FeatureNetConfig()
    net = feature_network.init_network(torch.Generator().manual_seed(0), feat_cfg)
    if args.feat_checkpoint:
        from ..models.partial_unet import load_torch_state_dict

        load_torch_state_dict(net, dict(np.load(args.feat_checkpoint)))
    net = net.to(dev)

    rng = np.random.default_rng(0)
    descs = []
    doc_ids = []
    for i, rec in enumerate(data.frames()):
        if i >= args.max_frames:
            break
        img = torch.as_tensor(rec.image, dtype=torch.float32, device=dev)
        with torch.no_grad():
            fdesc = feature_network.apply(net, img, torch.ones((1, *img.shape[1:]), device=dev))[1]
        fdesc = fdesc.cpu().numpy()
        c, h, w = fdesc.shape
        idx = rng.choice(h * w, args.points_per_frame, replace=False)
        descs.append(fdesc.reshape(c, -1).T[idx])
        doc_ids.append(np.full(len(idx), i, np.int64))
    train = np.concatenate(descs)
    print(f"training vocabulary on {len(train)} descriptors")
    # per-frame document ids give DBoW2's TF-IDF word weights
    voc = vocabulary.build_vocabulary(train, k=args.k, levels=args.levels,
                                      doc_ids=np.concatenate(doc_ids), device=dev)
    np.savez(
        args.output,
        children=voc.children.cpu().numpy().astype(np.int32),
        descriptors=voc.descriptors.cpu().numpy(),
        weights=voc.weights.cpu().numpy(),
        word_ids=voc.word_ids.cpu().numpy().astype(np.int32),
        num_words=voc.num_words,
        levels=voc.levels,
    )
    print(f"saved {voc.num_words}-word vocabulary to {args.output}")


if __name__ == "__main__":
    main()
