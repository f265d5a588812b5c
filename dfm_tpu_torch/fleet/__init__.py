"""Fleet serving: batched session multiplexing across tenants.

``open_fleet(results, panels)`` keeps B tenants' params and
capacity-padded panels device-resident in shape-bucketed batched buffers
(admission control assigns tenants to capacity classes through the
calibrated cost model); ``fleet.submit(tenant, rows)`` enqueues and
``fleet.drain()`` serves the queue as one batched tick per bucket (the
ragged per-tenant append, independent warm EM freezes, the smooth,
nowcasts and forecasts) with one blocking device->host read a tick, and
per-tenant answers pinned to the same tenant's lone ``NowcastSession``.
"""

from .admission import ClassAssignment, fleet_pad_waste, plan_admission
from .buffers import FleetBucket, TenantSlot
from .driver import SessionFleet, open_fleet, read_manifest, restore_fleet

__all__ = ["SessionFleet", "open_fleet", "restore_fleet", "read_manifest",
           "FleetBucket", "TenantSlot", "ClassAssignment",
           "plan_admission", "fleet_pad_waste"]
