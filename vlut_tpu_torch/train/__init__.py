"""Training-side helpers of the port (the float twin of a packed tree)."""
