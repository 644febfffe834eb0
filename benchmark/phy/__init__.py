"""PHY adapters: one module per configuration's ``phy``, naming its frozen
transmitter, the trellis steps a frame needs, how the receiver's input is
shaped, its detection rule's constants and the output fields the judge
holds to the frame sent."""
