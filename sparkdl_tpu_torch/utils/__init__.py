"""Device resolution and host metrics of the port."""
