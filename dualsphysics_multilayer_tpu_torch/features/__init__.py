"""Optional subsystems plugged into the solver step (the JAX package's
``features``): the floating bodies so far."""
