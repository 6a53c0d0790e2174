"""The control plane's names the port reads (a copy of the part of
``nos_tpu/constants.py`` the lifecycle notice watcher reaches): the
notice annotations a node carries, under the same domain, so the
port's trainer reads the reference control plane's stamps."""
from __future__ import annotations

DOMAIN = "nos.ai"
# GCE-style upcoming-maintenance notice: value is the window start time as
# wall-clock seconds (time.time — the one cross-host clock domain; see
# lifecycle/events.py)
ANNOTATION_MAINTENANCE_START = DOMAIN + "/maintenance-window-start"
# Spot/preemptible preemption notice: value is the ACPI-shutdown deadline
# (wall-clock seconds). Pods on the node have until then to bank progress
# — the trainer's stop-event checkpoint keys off this via
# lifecycle.events.preemption_signal_controller.
ANNOTATION_PREEMPTION_DEADLINE = DOMAIN + "/preemption-deadline"
