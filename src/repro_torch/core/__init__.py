"""FUSCO core: routing, descriptors, planner, the dComm engine and the
public MoE shuffle API (``fusco``)."""
