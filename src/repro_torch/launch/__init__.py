"""Launch tooling of the port: device meshes and the card's constants
(``mesh``), the abstract input and state specs of a cell (``specs``),
the tuned presets (``presets``), collective and roofline arithmetic
(``hlo_analysis``) and the multi-pod dry-run (``dryrun``)."""
