"""The virtual mesh: n ranks on one device."""
