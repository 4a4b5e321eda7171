"""The port's model architectures and their building blocks (importing
registers them)."""

from .modules import (  # noqa: F401
    attentions,
    decoders,
    encoders,
    pretrained_embeddings,
    scp_tss,
    text_embeddings,
    vision_embeddings,
)
from . import cross_modality_transformer  # noqa: F401
from . import hierarchical_co_attention  # noqa: F401
from . import iterative_m4c  # noqa: F401
from . import iterative_mcan  # noqa: F401
from . import iterative_saaa  # noqa: F401
from . import joint_transformer  # noqa: F401
from . import mcan  # noqa: F401
from . import mmf_lorra  # noqa: F401
from . import mmf_m4c  # noqa: F401
from . import mmf_variants  # noqa: F401
from . import parallel_attention_transformer  # noqa: F401
from . import saaa  # noqa: F401
from . import standalone_m4c  # noqa: F401
from . import unique_transformer  # noqa: F401
from . import vanilla_transformer  # noqa: F401
from . import vit_models  # noqa: F401
