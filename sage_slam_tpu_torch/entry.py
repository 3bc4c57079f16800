"""Entry points (port of __graft_entry__.py).

    python -m sage_slam_tpu_torch.entry [--device cpu] [--ranks N]

``entry()`` -> (fn, example_args): one window-BA LM iteration (ba.run_ba,
max_iters=1) on synthetic.graft_problem (K=4, 32x40, CS=FS=16, L=4,
N=512, consecutive-pair edges), K1 launched on the card.
``dryrun_multichip(n)`` runs one edge-sharded BA step
(parallel/sharded_ba.dryrun) and one keyframe-sharded compact mapping step
(parallel/sharded_store.dryrun) over ``n`` spawned ranks: rank r on card r
under NCCL unless ``devices`` names others, raising without enough cards.

main runs ``entry()``'s step and ``dryrun_multichip`` over the cards
present (``--ranks``; with ``--device`` every rank on that device) and
prints the device line, then __graft_entry__.py's two lines.
"""

from __future__ import annotations

import torch

from . import synthetic
from .bench import parser, start
from .config import MapperConfig
from .device import resolve_device
from .solver import ba


def entry(device=None):
    """One full window-BA linearize+solve iteration -> (fn, (variables,))."""
    variables, problem, pyr = synthetic.graft_problem(device=device)
    cfg = MapperConfig()
    update_mask = torch.ones(variables.num_kf, device=variables.code.device)

    def step(v):
        return ba.run_ba(v, problem, pyr, cfg, update_mask, max_iters=1)

    return step, (variables,)


def dryrun_multichip(n_devices: int, devices=None):
    """One edge-partitioned BA step and one keyframe-sharded compact
    mapping step over ``n_devices`` ranks -> (each rank's result of the
    first, of the second)."""
    from .parallel import sharded_ba, sharded_store

    return (sharded_ba.dryrun(n_devices, devices=devices),
            sharded_store.dryrun(n_devices, devices=devices))


def main(argv=None):
    ap = parser(__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=None,
                    help="ranks of dryrun_multichip (default: the cards present, or 1 with --device)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    start(dev, "entry")
    fn, example = entry(dev)
    out = fn(*example)
    shapes = [tuple(t.shape) for t in (out[0].pose.rot, out[0].pose.trans, out[0].code,
                                       out[0].scale, out[1])] + list(out[2:])
    print("entry OK:", shapes, flush=True)
    n = args.ranks or (torch.cuda.device_count() if args.device is None else 1)
    results = dryrun_multichip(n, None if args.device is None else [args.device] * n)
    print("dryrun_multichip OK", flush=True)
    return out, results


if __name__ == "__main__":
    main()
