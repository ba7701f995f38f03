"""The benchmark of ``hipad_torch`` on one NVIDIA H100 (``run.py``)."""
