#!/usr/bin/env python
"""Training / evaluation CLI of the PyTorch port, the counterpart of
``train_net.py`` with the same arguments and the same flow:

    python train_net_torch.py --config-file configs/fcos/fcos_R_50_FPN_1x.yaml \\
        [--eval-only] [--resume] [--device cpu] [--num-gpus N] \\
        [--num-machines M --machine-rank r --dist-url tcp://host:port] [KEY VALUE ...]

It runs on the card and fails where there is none, unless ``--device cpu``
asks for the CPU. ``--num-gpus N`` trains data-parallel in N processes on
this machine, one a card, over NCCL (``parallel.launch``, the reference's
``detectron2.engine.launch``); with ``--device cpu`` the N processes run on
the CPU over gloo. ``--num-machines``, ``--machine-rank`` and ``--dist-url``
join the processes of several machines (``train_multi_nodes_torch.sh``).
``SOLVER.IMS_PER_BATCH`` is the global batch, split evenly over the ranks.
``main`` is one process's work: the entry point calls it through
``launch``.
"""

import argparse


def default_argument_parser():
    parser = argparse.ArgumentParser(description="slenderobjdet_torch training")
    parser.add_argument("--config-file", default="", metavar="FILE")
    parser.add_argument("--eval-only", action="store_true")
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--device", default=None,
                        help="cuda (the default; an error without a card) or cpu")
    parser.add_argument("--num-gpus", type=int, default=1,
                        help="processes on this machine, one a card (CPU processes "
                             "with --device cpu)")
    parser.add_argument("--num-machines", type=int, default=1)
    parser.add_argument("--machine-rank", type=int, default=0,
                        help="this machine's index, 0 on the one that serves --dist-url")
    parser.add_argument("--dist-url", default="auto",
                        help="tcp://host:port of machine 0; auto picks a local port "
                             "(one machine only)")
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER,
                        help="dotted config overrides: KEY VALUE ...")
    return parser


def setup(args):
    from slenderobjdet_torch.config import get_cfg

    cfg = get_cfg()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    cfg.freeze()
    return cfg


def main(args):
    cfg = setup(args)

    from slenderobjdet_torch.engine.trainer import BaseTrainer, default_setup

    default_setup(cfg, args)
    trainer = BaseTrainer(cfg, device=args.device)
    trainer.resume_or_load(resume=args.resume)

    if args.eval_only:
        results = trainer.test()
        print(results)
        return results

    trainer.train()
    if cfg.DATASETS.TEST:
        return trainer.test()


def launch_main(args, **kwargs):
    """``main`` on every rank that the arguments name; returns this
    machine's ranks' results. ``kwargs`` go to ``launch`` (``backend``,
    ``timeout``, ``join_timeout``, ``force_group``)."""
    from slenderobjdet_torch.parallel import launch

    num_gpus = max(args.num_gpus, 1)
    if args.device == "cpu":
        kwargs.setdefault("backend", "gloo")
    elif num_gpus * args.num_machines > 1 or kwargs.get("force_group"):
        import torch

        if torch.cuda.is_available():
            # build the kernels once, before the ranks would race to
            from slenderobjdet_torch.ops import _build

            _build.build()
    return launch(main, num_gpus, num_machines=args.num_machines,
                  machine_rank=args.machine_rank, dist_url=args.dist_url, args=(args,),
                  **kwargs)


if __name__ == "__main__":
    launch_main(default_argument_parser().parse_args())
