"""Hyperparameter search of the PyTorch port (see driver.py)."""

from rcnn_ocr_tpu_torch.hpo.driver import (  # noqa: F401
    DEFAULT_SPACE,
    PrunedTrial,
    SuccessiveHalvingPruner,
    run_hpo,
)
