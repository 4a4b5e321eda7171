from . import classification_task  # noqa: F401  (registers ClassificationTask)
from . import ocr_tasks  # noqa: F401  (registers OcrOpenEndedTask, TrainingMMF, TrainingM4C, MmfClassificationTask)
from . import open_ended_task  # noqa: F401  (registers OpenEndedTask, TrainingSAAATask)
from . import vlsp_evjvqa_task  # noqa: F401  (registers VlspEvjVqaTask)
