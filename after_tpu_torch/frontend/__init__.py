"""Local web frontend of the port (counterpart of after_tpu/frontend)."""
