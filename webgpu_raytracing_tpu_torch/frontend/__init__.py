"""Frontends: the headless CLI (cli.py) and the live viewer (viewer.py)."""
