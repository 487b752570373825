"""Offline analysis/simulation studies backing documented design calls."""
