from . import ocr_tasks  # noqa: F401  (registers TrainingMMF)
