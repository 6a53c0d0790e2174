"""The workload side of the control plane's node lifecycle (a copy of
the part of ``nos_tpu/lifecycle/`` the trainer runs)."""
