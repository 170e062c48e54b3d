"""Radio devices of the port: the native rfsim IQ hub (built from
native/rfsim/rfsim.cpp into _build/) and the IQ record/replay device."""
