"""Network modules of ThreeDVNet."""
