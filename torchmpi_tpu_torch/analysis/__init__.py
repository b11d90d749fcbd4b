"""Analysis helpers of the port.

Only the instrumented-lock runtime monitor (:mod:`.lockmon`,
``TORCHMPI_TPU_LOCK_MONITOR=1``) is here: the telemetry core creates its
locks through it. The static lint rules of ``torchmpi_tpu/analysis`` are
written for JAX idioms and wait for ROADMAP A12.
"""
