"""Schedulers: DDIM tables and the RRG weight schedules (host-side numpy)."""
