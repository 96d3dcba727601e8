"""Data and tensor parallelism of the PyTorch port across processes (see mesh.py)."""

from rcnn_ocr_tpu_torch.parallel.mesh import (  # noqa: F401
    global_metric_sum,
    init_distributed,
    make_mesh,
    process_count,
    process_index,
)
