"""Serving: the OT request engine (``ot_engine``), its policy and synthetic traffic."""
