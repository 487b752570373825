"""Reporting and analysis: matrix export, plots, clique classification.

Reads only from the result store (like the reference's plot_run.py /
classify.py / export-run, which read only from layer 6 -- SURVEY.md
section 1).
"""
