"""Configuration helpers of the port."""
