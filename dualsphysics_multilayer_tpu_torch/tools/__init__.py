"""Tools that run beside the solver: the hardware probes (``probes``) and
the helpers the run output shares with the post-processors (``common``)."""
