"""Federated simulation: tasks, client fleet, devices, network, simulator, experiments."""
