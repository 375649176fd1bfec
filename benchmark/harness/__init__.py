"""The benchmark's own code: inputs, the drive of the program and of the
reference, the window, the trace and the arithmetic of the metrics. It
imports the program (rtsdm_tpu_torch) only inside drive.Driver and never
the JAX package."""
