"""Operations and bytes from shapes, and the card's peaks."""
