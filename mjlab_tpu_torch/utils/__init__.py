"""Host-side helpers of the port: noise, actuator modeling, spec configs."""
