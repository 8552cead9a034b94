"""Seconds from the start of the process to the start of the window:
imports, kernel load (or build), inputs made on the card, warm-up."""


def read(run):
    return run.get("setup_s")
