"""Training-side helpers of the port (so far only what inference shares
with the input pipeline)."""
