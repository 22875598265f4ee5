"""Tools of the port, each runnable as
``python -m slenderobjdet_torch.tools.<name>``: the measurement tools on a
CUDA card, ``coco_to_pack`` on any host."""
