"""models of the PyTorch port (see rcnn_ocr_tpu_torch/__init__.py)."""
