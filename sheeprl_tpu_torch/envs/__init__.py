"""The port's environments: space descriptors (``spaces``) and the
device-resident env families (``device``)."""
