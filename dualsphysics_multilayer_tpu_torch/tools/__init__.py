"""Tools that run beside the solver: the hardware probes (``probes``)."""
