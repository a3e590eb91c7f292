"""Launch entry of the port: gang-scheduling jobs onto cluster slices."""
from .cluster import TPUJob, job_from_roofline, schedule_cluster  # noqa: F401
