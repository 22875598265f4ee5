"""Tools of the port, each runnable as
``python -m slenderobjdet_torch.tools.<name>``: those that build a model or
measure on a CUDA card (or the CPU where they take ``--device cpu``); the
readers, the launchers and ``coco_to_pack`` on any host."""
