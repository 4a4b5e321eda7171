from .instance import Batch, Instance, collate  # noqa: F401
