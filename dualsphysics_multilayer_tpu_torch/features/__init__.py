"""Optional subsystems plugged into the solver step (the JAX package's
``features``): floating bodies, scripted motion and the wave-flume family
(wave generation, AWAS, damping, relaxation zones, multi-layer pistons,
gauges) and external accelerations."""
