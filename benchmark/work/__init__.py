"""Operations and bytes of the problem a cell computes, and the card's
published peaks: the yardstick of the rooflines and MFU readers."""
