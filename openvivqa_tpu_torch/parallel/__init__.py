"""Scale-out over ``torch.distributed``: the process group and eval gathering
(``multihost.py``), the data mesh and the DDP / FSDP training wrappers
(``mesh.py``)."""
