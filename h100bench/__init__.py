"""The port's benchmark on one NVIDIA H100 (see ``run.py``)."""
