"""repro_torch.sensor — measured ReuseSensor telemetry & cost accounting.

* ``counters``   — per-site counter tensors riding inside reuse-cache
                   entries (updated on the hot path, on the device);
* ``aggregate``  — host-side reduction across sites/layers/slots into a
                   :class:`SensorReport` with JSONL emission;
* ``cost_model`` — cycles + energy derived from *measured* counters;
* ``runner``     — drives real decode steps and returns the resulting report
                   (imported as ``repro_torch.sensor.runner``, not
                   re-exported here: it pulls in the serving stack, which
                   imports this package).
"""

from repro_torch.sensor.aggregate import (
    SENSOR_SCHEMA_VERSION,
    SensorReport,
    SiteSensor,
    build_report,
    slot_telemetry,
)
from repro_torch.sensor.counters import (
    init_site_counters,
    update_on_basic,
    update_on_reuse,
)
from repro_torch.sensor.cost_model import (
    E_HBM,
    E_ICI,
    E_MAC,
    STATIC_W,
    measured_skip_fractions,
    sensor_energy,
    sensor_speedup,
)

__all__ = [
    "E_HBM",
    "E_ICI",
    "E_MAC",
    "SENSOR_SCHEMA_VERSION",
    "STATIC_W",
    "SensorReport",
    "SiteSensor",
    "build_report",
    "init_site_counters",
    "measured_skip_fractions",
    "sensor_energy",
    "sensor_speedup",
    "slot_telemetry",
    "update_on_basic",
    "update_on_reuse",
]
