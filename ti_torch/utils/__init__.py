"""Host-side utilities: metric logging and ``profile_trace``
(``logging``), CUDA-event timing (``timing``), the trace summariser
(``profiling``) and the import of the reference's torch checkpoints
(``torch_import``)."""
