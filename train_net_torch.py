#!/usr/bin/env python
"""Training / evaluation CLI of the PyTorch port, the counterpart of
``train_net.py`` with the same arguments and the same flow:

    python train_net_torch.py --config-file configs/fcos/fcos_R_50_FPN_1x.yaml \\
        [--eval-only] [--resume] [--device cpu] [KEY VALUE ...]

It runs on the first CUDA device and fails where there is none, unless
``--device cpu`` asks for the CPU. --num-gpus/--num-machines/--machine-rank/
--dist-url are accepted for CLI compatibility and unused: the port runs in
one process on one device.
"""

import argparse


def default_argument_parser():
    parser = argparse.ArgumentParser(description="slenderobjdet_torch training")
    parser.add_argument("--config-file", default="", metavar="FILE")
    parser.add_argument("--eval-only", action="store_true")
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--device", default=None,
                        help="cuda (the default; an error without a card) or cpu")
    parser.add_argument("--num-gpus", type=int, default=0,
                        help="accepted for parity; one device is used")
    parser.add_argument("--num-machines", type=int, default=1)
    parser.add_argument("--machine-rank", type=int, default=0)
    parser.add_argument("--dist-url", default="auto")
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


if __name__ == "__main__":
    args = default_argument_parser().parse_args()
    main(args)
