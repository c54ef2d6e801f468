"""Launch helpers: meshes of ``torch.distributed`` ranks for the SPMD
epoch (``mesh.py``)."""
