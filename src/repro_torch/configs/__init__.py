"""Model configurations of the architectures the port runs."""
