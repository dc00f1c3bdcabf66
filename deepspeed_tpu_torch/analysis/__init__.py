"""Environment knobs of the port (``knobs``)."""
