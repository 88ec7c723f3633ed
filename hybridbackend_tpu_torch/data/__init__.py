"""Host-to-device data plane of the port: prefetch and replica sync."""
