"""Kinds of cell, one module each, named by a traffic mix's ``kind``."""
