"""Protocol core: flat plane, topology, events, channel, DRACO windows."""
