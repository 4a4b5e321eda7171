from . import image_datasets  # noqa: F401  (registers the raw-image datasets)
from . import multilingual  # noqa: F401  (registers the EVJVQA and multimodal vocabs, datasets)
from . import ocr_datasets  # noqa: F401  (registers the dataset family)
from . import ocr_vocab  # noqa: F401  (registers the vocab family)
from . import word_embedding  # noqa: F401  (registers word embeddings)
from .loader import DataLoader  # noqa: F401
